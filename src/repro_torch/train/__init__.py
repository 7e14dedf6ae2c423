"""Training of the port: the step factories (:mod:`.step`) and the
fault-tolerant loop with energy accounting (:mod:`.loop`)."""
