"""General drivers: each reads its traffic mix's parameters and runs the
program's path for them. A mix names its driver (``"driver"``)."""
