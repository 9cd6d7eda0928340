"""Distributed runtime of the port: the one-card and sharded train steps,
the prefill and decode steps, logical-axis sharding rules and partitioning,
the collectives that stand in for GSPMD's, gradient compression, GPipe,
and fault tolerance (heartbeats, straggler detection, remesh planning)."""
