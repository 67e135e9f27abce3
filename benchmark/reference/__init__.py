"""Plain references the benchmark holds the program's outputs against. They
import nothing of the program and nothing of JAX."""
