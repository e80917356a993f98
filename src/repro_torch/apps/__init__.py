"""Mini-applications that drive the port end to end (``lsms``)."""
