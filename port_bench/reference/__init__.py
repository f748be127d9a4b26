"""Plain references of the configurations, and the numbers that decide
``correct``.  They import nothing of the program."""
