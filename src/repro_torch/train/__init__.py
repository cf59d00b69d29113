"""The training side of the port, so far only the DHash router table of
``train_step`` (``make_router_table``, ``rebalance_router``)."""
