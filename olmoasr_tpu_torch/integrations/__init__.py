"""Exports of the port's checkpoints to other frameworks."""
