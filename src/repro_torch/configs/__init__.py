"""Model configurations of the port (:mod:`repro.configs`' schema): the
reference's ten architectures, each with its full ``CONFIG`` and its
``REDUCED`` smoke variant, field for field."""
