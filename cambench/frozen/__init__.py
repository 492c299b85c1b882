"""Frozen copies of the program's generators (see each module's header).

Later changes to ``src/repro_torch`` do not change the benchmark's inputs.
"""
