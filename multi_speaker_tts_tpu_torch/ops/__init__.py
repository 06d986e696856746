"""Kernel wrappers and plain tensor ops of the torch port."""
