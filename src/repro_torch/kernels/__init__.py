"""The port's kernels: hand-written CUDA for Hopper.

Each kernel module (``gf_matmul``, ``gear_cdc``, ``sha1``,
``fused_ingest`` for the storage data plane, ``flash_attn`` for the
models' attention) holds the
wrapper of one CUDA source under ``csrc/`` beside its plain torch version
(``ref``); ``ops`` is the dispatch layer the engines call, ``_build``
compiles and loads the sources, ``tables`` holds the fixed tables and
``launches`` the counters.  Importing this package builds nothing: the
kernels are built at their first launch.
"""
