"""The language models of the serving path, in eager PyTorch.

Mirrors ``repro/models`` for the dense transformer family (``layers``,
``attention``, ``params``, ``transformer``, ``model``); the other families
raise ``NotImplementedError`` until their slice of the port lands.
"""
