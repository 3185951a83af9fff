"""Plain fp32 references that decide ``correct``. They import nothing of
the program: every piece is a frozen copy written in PyTorch or NumPy."""
