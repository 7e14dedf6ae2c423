"""The port's launchers: process meshes for the sharded paths and the
dry run (:mod:`.mesh`), the serving CLI (:mod:`.serve`), the training
CLI (:mod:`.train`) and the dry run (:mod:`.dryrun`, with its counts
:mod:`.opcount` and its roofline :mod:`.roofline`)."""
