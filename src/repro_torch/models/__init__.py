"""The language models of the serving path, in eager PyTorch.

Mirrors ``repro/models`` for every family: GQA transformers (dense / MoE /
VLM / audio, ``transformer`` and ``moe``), RWKV6 (``rwkv``) and the Zamba2
hybrid (``mamba2``), behind ``model``'s dispatch.  The training side
(losses, remat) is not ported yet.
"""
