"""The port's serving CLI (``python -m repro_torch.launch.serve``) against
the JAX package's (``repro.launch.serve``).

Both CLIs serve the same 8 requests through their ``ServingEngine``s.
The port draws its own weights, so for the comparison its
``api.init_params`` is patched to carry the reference's tree across
(``convert.lm_params``), and both sides' ``get_config`` are patched to
float32.  The reference runs on JAX's CPU backend at "highest" matmul
precision (``tests/_torch_jax_ref.py``).  Its printed request lines must
be the port's, token for token.
"""
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_jax_ref import ref  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

SERVED = re.compile(r"served (\d+)/(\d+) requests, (\d+) tokens in "
                    r"[0-9.]+s \([0-9.]+ tok/s\), (\d+) ticks")


class Stop(Exception):
    """Raised by a patched step of ``main`` to end it there."""


def _f32(get):
    return lambda arch, reduced=False: get(arch, reduced=reduced).replace(
        param_dtype="float32")


def _lines(text):
    """(the served line's counts, the request lines)."""
    lines = text.strip().splitlines()
    m = SERVED.fullmatch(lines[0])
    assert m, lines[0]
    return m.groups(), lines[1:]


#: the archs the CLI serves: token LMs, not encoder-decoder or embeds
TOKEN_ARCHS = tuple(a for a in registry.ARCH_IDS
                    if not registry.get_config(a).encdec
                    and registry.get_config(a).input_mode == "tokens")


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_cli_prints_the_reference_tokens(arch, monkeypatch, capsys):
    monkeypatch.setattr(rserve, "get_config", _f32(rreg.get_config))
    monkeypatch.setattr(serve, "get_config", _f32(registry.get_config))
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch])
    ref(rserve.main)
    want = capsys.readouterr().out
    rcfg = rreg.get_config(arch, reduced=True).replace(param_dtype="float32")
    rp = ref(lambda: rapi.init_params(jax.random.PRNGKey(0), rcfg))
    seeds = []

    def carried(seed, cfg, device):
        seeds.append((seed, device))
        return convert.lm_params(rp, cfg, device)
    monkeypatch.setattr(serve.api, "init_params", carried)
    serve.main(["--arch", arch, "--torch-device", "cpu"])
    got = capsys.readouterr().out
    assert seeds == [(0, "cpu")]
    (done, n, toks, ticks), lines = _lines(got)
    assert (done, n, toks) == ("8", "8", "128")
    assert _lines(want) == ((done, n, toks, ticks), lines)
    assert len(lines) == 3 and lines[0].startswith("  req0: [")


@pytest.mark.parametrize("argv, reduced", [
    ([], True), (["--reduced"], True), (["--no-reduced"], False)])
def test_reduced_is_the_default_and_no_reduced_serves_the_full_config(
        argv, reduced, monkeypatch):
    """The reference's ``--reduced`` (store_true, default True) cannot be
    switched off; the port's ``--no-reduced`` serves the full config."""
    seen = []

    def init(seed, cfg, device):
        seen.append(cfg)
        raise Stop
    monkeypatch.setattr(serve.api, "init_params", init)
    with pytest.raises(Stop):
        serve.main(argv + ["--arch", "qwen2-moe-a2.7b", "--torch-device",
                           "cpu"])
    assert seen == [registry.get_config("qwen2-moe-a2.7b", reduced=reduced)]
    assert (seen[0].n_layers == 24) == (not reduced)


def test_default_arch_and_device(monkeypatch):
    """olmo-1b on the card by default, as the reference's default arch;
    without a card the default refuses and names ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.main([])
    seen = []

    def init(seed, cfg, device):
        seen.append(cfg)
        raise Stop
    monkeypatch.setattr(serve.api, "init_params", init)
    with pytest.raises(Stop):
        serve.main(["--torch-device", "cpu"])
    assert [cfg.name for cfg in seen] == ["olmo-1b"]


@pytest.mark.parametrize("change", [
    dict(encdec=True, n_enc_layers=1, n_dec_layers=1),
    dict(input_mode="embeds")])
def test_cli_refuses_encdec_and_embeds_archs(change, monkeypatch):
    monkeypatch.setattr(serve, "get_config", lambda arch, reduced: (
        registry.get_config(arch, reduced=reduced).replace(**change)))
    with pytest.raises(SystemExit, match="token-LM"):
        serve.main(["--torch-device", "cpu"])


def test_cli_refuses_an_arch_the_port_lacks(capsys):
    """An arch outside the registry is argparse's invalid choice; the
    choices it names are the reference's ten archs."""
    with pytest.raises(SystemExit) as err:
        serve.main(["--arch", "no-such-arch", "--torch-device", "cpu"])
    assert err.value.code == 2
    msg = capsys.readouterr().err
    assert "invalid choice" in msg
    choices = msg.split("choose from ")[1].split(")")[0]
    assert tuple(c.strip("' ") for c in choices.split(",")) == rreg.ARCH_IDS


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "seamless-m4t-medium"])
def test_cli_refuses_the_embeds_and_encdec_archs_as_the_reference(
        arch, monkeypatch):
    """The reference's message, from both CLIs, before any weights are
    drawn."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch])
    with pytest.raises(SystemExit, match="targets token-LM archs") as want:
        rserve.main()
    monkeypatch.setattr(serve.api, "init_params", lambda *a: 1 / 0)
    with pytest.raises(SystemExit) as got:
        serve.main(["--arch", arch, "--torch-device", "cpu"])
    assert str(got.value) == str(want.value)


def test_cli_requests_follow_the_reference_prompts(capsys):
    """--requests, --new-tokens and --slots reach the engine; the prompts
    are the reference's, 8 tokens each from numpy's seed 0 in [1,
    vocab)."""
    serve.main(["--arch", "granite-moe-3b-a800m", "--torch-device", "cpu",
                "--requests", "3", "--new-tokens", "2", "--slots", "2"])
    (done, n, toks, ticks), lines = _lines(capsys.readouterr().out)
    assert (done, n, toks) == ("3", "3", "6")
    rng = np.random.default_rng(0)
    vocab = registry.get_config("granite-moe-3b-a800m", reduced=True).vocab
    for i, line in enumerate(lines):
        prompt = rng.integers(1, vocab, size=8).astype(np.int32)
        assert line.startswith(f"  req{i}: {list(prompt)} -> [")
