"""The port's launchers: process meshes for the sharded paths
(:mod:`.mesh`) and the serving CLI (:mod:`.serve`)."""
