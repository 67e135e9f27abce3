"""The benchmark's own arithmetic, frozen: FLOPs, operations and bytes
counted from shapes, and the card's peaks. It imports nothing of the
program, so a change to the program cannot move the yardstick."""
