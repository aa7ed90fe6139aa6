"""Kernel 5's front-wait share (``iq_ball_mlp3``): of the h1 tiles its
consumer warpgroups multiplied in the window (the port's work counter
``k5_tiles``), those at which a consumer found the tile not yet written by
the producer warpgroup's ball query and layer 1 (``k5_front_waits``), as a
share (moves ``forwards_per_s``).  High: the front sets kernel 5's pace;
low: the products do.

The port counts only while tracing, and drops a counter that counted
nothing: with ``k5_tiles`` there and no ``k5_front_waits`` the share is 0;
without ``k5_tiles`` (a port without the pipeline) there is none.
"""
from iqbench.port_counts import port_counter


def read(ctx):
    tiles = port_counter("k5_tiles")
    if not tiles:
        return None
    return 100.0 * (port_counter("k5_front_waits") or 0) / tiles
