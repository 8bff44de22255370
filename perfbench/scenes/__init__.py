"""Frozen scene generators: the inputs both the port and the plain
reference are given. One module per configuration ``builder``."""
