"""Plain references that judge the program's answers; they import nothing of it."""
