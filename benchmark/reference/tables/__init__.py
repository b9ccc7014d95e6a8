"""The model's data tables that the program and the reference both read."""
