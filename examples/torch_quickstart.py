"""Quickstart on the PyTorch/CUDA port: SEARS as a file store -- upload,
dedup, code, fail, restore.

The twin of ``quickstart.py`` on ``repro_torch``.  It runs on the card
(the fused single-launch hash + encode kernel); ``--device cpu`` runs
the same store on the host's ``"numpy"`` engine, byte-identical.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.classes import StorageClass
from repro_torch.core.engine import TorchFusedEngine
from repro_torch.core.store import SEARSStore


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # a 4-cluster SEARS deployment: one (n=10, k=5) ULB storage class.
    # On the card the fused engine runs put windows through the
    # single-launch hash+encode kernel (engine="numpy"/"kernel" are
    # byte-identical).
    store = SEARSStore(
        classes=[StorageClass(name="default", n=10, k=5, binding="ulb")],
        num_clusters=4, node_capacity=1 << 30,
        engine=TorchFusedEngine() if args.device == "cuda" else "numpy")

    rng = np.random.default_rng(0)
    report = rng.integers(0, 256, size=300_000, dtype=np.int64).astype(
        np.uint8).tobytes()

    # --- upload: chunked, hashed, deduped, erasure coded -----------------
    st = store.put_file("alice", "report.doc", report)
    print(f"upload: {st.n_chunks} chunks, {st.n_new_chunks} new, "
          f"{st.bytes_uploaded / 1e3:.0f} kB sent, "
          f"{st.piece_bytes_written / 1e3:.0f} kB stored (n/k = 2x)")

    # --- duplicate content costs nothing ---------------------------------
    st2 = store.put_file("alice", "report-final.doc", report)
    print(f"re-upload: {st2.n_new_chunks} new chunks, "
          f"{st2.bytes_uploaded} bytes sent (dedup)")

    # --- a streaming backlog: double-buffered put windows ----------------
    backlog = [[("bob", [(f"batch{w}/part{i}",
                          rng.integers(0, 256, size=60_000, dtype=np.int64)
                          .astype(np.uint8).tobytes())
                         for i in range(3)])]
               for w in range(3)]
    stats = store.put_windows_pipelined(backlog)
    print(f"pipelined ingest: {len(stats)} windows, "
          f"{sum(s.n_chunks for w in stats for s in w)} chunks "
          f"(window i+1 chunks on device while window i plans on host)")

    # --- half the storage nodes die; the files survive -------------------
    for cluster in store.clusters:
        cluster.kill_nodes([0, 2, 4, 6, 8])
    data, rst = store.get_file("alice", "report.doc")
    assert data == report
    print(f"retrieval with 5/10 nodes dead: OK, modeled {rst.time_s:.2f}s "
          f"({rst.n_fetched} chunks from {rst.clusters_touched} cluster)")

    # --- prefetched multi-file get: next window reads+decodes early ------
    names = [f"batch{w}/part{i}" for w in range(3) for i in range(3)]
    results = store.get_files_pipelined("bob", names, window_files=3)
    assert all(len(data) == 60_000 for data, _ in results)
    print(f"pipelined degraded get: {len(results)} files OK, "
          f"mean modeled {np.mean([r.time_s for _, r in results]):.2f}s")

    # --- storage accounting ------------------------------------------------
    s = store.stats()
    print(f"dedup ratio (logical/consumed incl. index): {s.dedup_ratio:.2f}")


if __name__ == "__main__":
    main()
