"""Launchers: ``serve`` (the serving CLI), ``train`` (sharded training
with auto-resume) and ``mesh`` (the host and production meshes)."""
