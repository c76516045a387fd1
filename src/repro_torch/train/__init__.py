"""Serving steps over the model stack (``serve.py``); the training step and
optimizers come with the training slice."""
