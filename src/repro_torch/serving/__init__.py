"""Serving: the continuous batcher.  The single-host server, the ifunc
front end and the disaggregated fabric come with the serving slice."""

from repro_torch.serving.batcher import ContinuousBatcher, Request, synth_slot_pos

__all__ = ["ContinuousBatcher", "Request", "synth_slot_pos"]
