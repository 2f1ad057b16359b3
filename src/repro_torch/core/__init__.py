"""The collective library: topology, schedule IR, algorithm builders,
compiled executor, selector, transports and the ``mpix_*`` API."""
