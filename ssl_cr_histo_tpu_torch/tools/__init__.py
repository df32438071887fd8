"""Tools that drive the port's CLIs end to end (``tools.rehearsal``)."""
