"""Plain references that decide ``correct``. They import nothing of the
program: frozen copies of the arithmetic they judge by."""
