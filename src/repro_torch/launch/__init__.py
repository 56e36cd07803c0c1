"""Launch tools of the port: the serving entry point so far."""
