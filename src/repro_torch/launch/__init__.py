"""Launch tools of the port: the serving entry point, the meshes, the
pod-scale train step and its sharding and roofline arithmetic."""
