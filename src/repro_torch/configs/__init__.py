"""Model configurations of the port (:mod:`repro.configs`' schema).

Only the architectures whose blocks the port runs are registered:
recurrentgemma-9b (RG-LRU and local attention), olmo-1b (dense, the
non-parametric norm), granite-moe-3b-a800m and qwen2-moe-a2.7b
(mixture of experts).  ``get_config`` of any
other architecture raises ``KeyError`` naming ROADMAP A.6.
"""
