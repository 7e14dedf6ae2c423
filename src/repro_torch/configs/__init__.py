"""Model configurations of the port (:mod:`repro.configs`' schema).

Only the architectures whose blocks the port runs are registered:
recurrentgemma-9b (RG-LRU and local attention).  ``get_config`` of any
other architecture raises ``KeyError`` naming ROADMAP A.6.
"""
