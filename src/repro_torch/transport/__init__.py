"""The transport layer: fabric contract, progress engine, dispatcher and
the device-mesh fabric."""

from repro_torch.transport.device_fabric import DeviceMeshFabric
from repro_torch.transport.dispatcher import Dispatcher, Peer, RingState
from repro_torch.transport.fabric import (Channel, Fabric, Mailbox,
                                          TransportError)
from repro_torch.transport.progress import ProgressEngine

__all__ = ["Channel", "DeviceMeshFabric", "Dispatcher", "Fabric", "Mailbox",
           "Peer", "ProgressEngine", "RingState", "TransportError"]
