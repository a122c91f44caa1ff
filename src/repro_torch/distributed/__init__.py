"""Distribution: mesh axes and sharding rules over a torch ``DeviceMesh``."""
