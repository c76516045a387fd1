"""The transport layer: fabric contract, the RDMA and device-mesh fabrics,
progress engine and dispatcher."""

from repro_torch.transport.device_fabric import DeviceMeshFabric
from repro_torch.transport.dispatcher import Dispatcher, Peer, RingState
from repro_torch.transport.fabric import (Channel, Fabric, LegacyRingMailbox,
                                          Mailbox, RdmaChannel, RdmaFabric,
                                          RdmaMailbox, TransportError,
                                          endpoint_channel, frame_fits,
                                          ring_mailbox)
from repro_torch.transport.progress import ProgressEngine

__all__ = ["Channel", "DeviceMeshFabric", "Dispatcher", "Fabric",
           "LegacyRingMailbox", "Mailbox", "Peer", "ProgressEngine",
           "RdmaChannel", "RdmaFabric", "RdmaMailbox", "RingState",
           "TransportError", "endpoint_channel", "frame_fits",
           "ring_mailbox"]
