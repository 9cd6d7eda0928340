"""Distributed runtime of the port: the train step (one card) and fault
tolerance (heartbeats, straggler detection, remesh planning)."""
