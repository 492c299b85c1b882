"""The cases the multi-device parity tests share between the JAX
reference (``_jax_mesh_ref.py``) and the port's ranks (``_torch_mesh.py``);
imports neither package."""

#: (case, arch, mesh shape, axis names, recipe fields) of the step cases.
STEP_CASES = (
    ("dense", "starcoder2-3b", (2, 2), ("data", "model"), {}),
    ("moe", "qwen2-moe-a2.7b", (2, 2), ("data", "model"), {}),
    ("pod", "starcoder2-3b", (2, 1, 2), ("pod", "data", "model"),
     {"batch_axes": ("pod", "data"), "compress_pod_grads": True}),
)
STEPS = 2
#: (case, arch, cache dtype) of the decode cases: three steps of a float32
#: model on (data 2, model 2), the cache split by batch and by length
#: ("kv_seq"), against the same steps without a mesh.
DECODE_CASES = (
    ("dense", "starcoder2-3b", "float32"),
    ("int8", "starcoder2-3b", "int8"),
    ("moe", "qwen2-moe-a2.7b", "float32"),
    ("hybrid", "zamba2-2.7b", "float32"),
)
#: the decode rows' context lengths: cache length 16, split at 8 (row 1
#: crosses the split in its three steps)
DECODE_LENGTHS = (2, 7, 8, 12)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
RECIPE = dict(remat="block")
#: (mesh shape, axis names, global shape, spec) of the placement cases.
PLACEMENTS = (
    ((2, 2), ("data", "model"), (8, 6), ("data", "model")),
    ((2, 2), ("data", "model"), (8, 6), ("model", None)),
    ((2, 2), ("data", "model"), (4, 8, 6), (None, ("data", "model"), None)),
    ((2, 2, 1), ("pod", "data", "model"), (8, 6), (("pod", "data"), None)),
    ((2, 1, 2), ("pod", "data", "model"), (8, 4, 6),
     (("pod", "data"), None, "model")),
)
