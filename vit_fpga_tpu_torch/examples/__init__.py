"""Runnable examples of the port."""
