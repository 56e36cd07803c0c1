"""Launch tools of the port: the serving entry point and the data mesh."""
