"""Models of the port: the dense decoder's layers and assembly."""
