"""The transport layer: fabric contract, the RDMA, loopback and device-mesh
fabrics, progress engine, dispatcher, the deterministic fault injector and
the streams' wire codecs (``repro_torch.transport.codec``)."""

from repro_torch.transport.device_fabric import DeviceMeshFabric
from repro_torch.transport.dispatcher import (DEFAULT_N_SLOTS,
                                              DEFAULT_SLOT_SIZE, Dispatcher,
                                              Peer, RingState)
from repro_torch.transport.faults import FaultInjector
from repro_torch.transport.fabric import (Channel, Fabric, LegacyRingMailbox,
                                          LoopbackChannel, LoopbackFabric,
                                          LoopbackMailbox, Mailbox,
                                          RdmaChannel, RdmaFabric,
                                          RdmaMailbox, TransportError,
                                          endpoint_channel, frame_fits,
                                          ring_mailbox)
from repro_torch.transport.progress import (Completion, ProgressEngine,
                                            TxHandle)

__all__ = ["Channel", "Completion", "DEFAULT_N_SLOTS", "DEFAULT_SLOT_SIZE",
           "DeviceMeshFabric", "Dispatcher", "Fabric", "FaultInjector",
           "LegacyRingMailbox", "LoopbackChannel", "LoopbackFabric",
           "LoopbackMailbox", "Mailbox", "Peer", "ProgressEngine",
           "RdmaChannel", "RdmaFabric", "RdmaMailbox", "RingState",
           "TransportError", "TxHandle", "endpoint_channel", "frame_fits",
           "ring_mailbox"]
