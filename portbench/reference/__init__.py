"""The plain reference (NumPy) and the comparison that decides
``correct``.  Imports nothing of the port and takes nothing it made."""
