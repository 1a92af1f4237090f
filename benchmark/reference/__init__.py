"""The plain reference the benchmark judges the program against."""
