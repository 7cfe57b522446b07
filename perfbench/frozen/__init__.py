"""Frozen copies of program code the yardstick relies on. Each module names
the file and commit it came from; later changes to the program do not
reach them."""
