"""Distribution substrate of the port.

So far the host-side fault-tolerance policies (``dist.fault``), which
the serving layer's watchdog and straggler tracking use.  Sharding,
collectives and the sharded apply and program wait for ROADMAP item 14.
"""

from repro_torch.dist import fault  # noqa: F401
