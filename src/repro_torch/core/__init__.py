"""SEARS core on PyTorch: chunking, dedup, erasure coding, binding, storage.

The control plane is a copy of the JAX reference's ``repro.core``; the
data plane runs through ``TorchEngine`` or ``TorchFusedEngine`` (CUDA
kernels on the card).
"""

from repro_torch.core.binding import ChunkLevelBinding, UserLevelBinding, make_binding
from repro_torch.core.chunking import Chunker, DEFAULT_CHUNKER
from repro_torch.core.classes import StorageClass, partition_pools
from repro_torch.core.engine import (CodingEngine, NumpyEngine, TorchEngine,
                                     TorchFusedEngine, make_engine)
from repro_torch.core.hashing import chunk_id, fast_chunk_id
from repro_torch.core.latency import LatencyParams, calibrate
from repro_torch.core.radmad import RADMADStore
from repro_torch.core.repair import RepairManager, RepairReport
from repro_torch.core.rs_code import RSCode
from repro_torch.core.scheduler import (BatchScheduler, Request, RequestFuture,
                                        RequestQueue)
from repro_torch.core.store import SEARSStore

__all__ = [
    "ChunkLevelBinding", "UserLevelBinding", "make_binding",
    "Chunker", "DEFAULT_CHUNKER", "chunk_id", "fast_chunk_id",
    "StorageClass", "partition_pools",
    "CodingEngine", "NumpyEngine", "TorchEngine", "TorchFusedEngine",
    "make_engine",
    "LatencyParams", "calibrate", "RADMADStore", "RepairManager",
    "RepairReport", "RSCode", "SEARSStore",
    "BatchScheduler", "Request", "RequestFuture", "RequestQueue",
]
