"""Launchers: ``serve`` (the serving CLI).  ``train`` and ``mesh`` wait
on the parallelism layer."""
