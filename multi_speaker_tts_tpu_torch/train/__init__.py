"""Training: the optimizer chain and the teacher-forced train step."""
