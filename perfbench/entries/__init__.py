"""Entries: how a traffic mix drives the port. One module per mix
``entry``; each has a ``Runner``."""
