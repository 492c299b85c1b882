"""Drivers: the general generators a traffic file names (``"driver"``).

``run(ctx)`` sets the cell up from its files and ``--seed``, runs the
window, checks what the window produced against ``cambench.reference`` and
returns ``correct``, ``attempted``, ``failed``, the end-to-end values, the
compared numbers with their limits, the memory peak and, in a traced run,
the readings of the per-layer metrics.
"""
