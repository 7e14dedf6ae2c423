"""The port's launchers: process meshes for the sharded paths
(:mod:`.mesh`), the serving CLI (:mod:`.serve`) and the training CLI
(:mod:`.train`)."""
