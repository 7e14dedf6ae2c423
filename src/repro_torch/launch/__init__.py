"""Process meshes for the port's sharded paths (:mod:`.mesh`)."""
