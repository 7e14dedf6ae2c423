"""The language model of the port: recurrentgemma-9b's blocks (RG-LRU and
local attention with a dense MLP), the dense and mixture-of-experts
attention decoders (olmo-1b, granite-moe-3b-a800m, qwen2-moe-a2.7b;
:mod:`.moe`), prefill, decode and the model API.

Parameters and caches are plain nested dicts of tensors in the JAX
package's layout (blocks stacked over pattern periods), so
:func:`repro_torch.convert.lm_params` carries a reference tree across
leaf by leaf.  The two sequence mixers run the port's CUDA kernels on the
card (:mod:`repro_torch.kernels.rglru_scan`,
:mod:`repro_torch.kernels.flash_attention`).
"""
