"""Model modules of the torch port."""
