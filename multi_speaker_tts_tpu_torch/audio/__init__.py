"""Audio front-end of the torch port."""
