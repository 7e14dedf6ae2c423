"""The port's keyed stream (Philox4x32-10 in plain PyTorch) and what the
fleet's draws gain from it.

* Random123's known answers for Philox4x32-10, and the 16-bit split
  product against Python's exact integers;
* a draw depends on its key and counter alone: not on which other rows
  share the call, nor on the batch shape;
* the integer words are the same on the CPU and the card (that half
  skips without a card);
* uniforms lie in [0, 1) with 53 bits, normals have the moments of a
  standard normal.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.engine_backend import keyed_rng as kr  # noqa: E402

I64 = torch.int64

# Random123 kat_vectors, philox4x32 with 10 rounds: counter, key, output
KNOWN_ANSWERS = [
    ((0x00000000, 0x00000000, 0x00000000, 0x00000000),
     (0x00000000, 0x00000000),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff),
     (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def _words(*vals):
    return [torch.tensor([v], dtype=I64) for v in vals]


@pytest.mark.parametrize("ctr, key, want", KNOWN_ANSWERS,
                         ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    got = kr.philox4x32(*_words(*ctr), *key)
    assert [int(w) for w in got] == list(want)
    # the key may also come as int64 tensors (per-row keys)
    got_t = kr.philox4x32(*_words(*ctr), *_words(*key))
    assert [int(w) for w in got_t] == list(want)


def test_split_product_is_exact():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.int64)
    x[:4] = [0, 1, 2**32 - 1, 2**31]
    for m in (kr._M0, kr._M1, 2**32 - 1):
        hi, lo = kr._mulhilo(m, torch.as_tensor(x))
        prod = [int(v) * m for v in x]
        assert hi.tolist() == [p >> 32 for p in prod]
        assert lo.tolist() == [p & 0xFFFFFFFF for p in prod]


def test_a_draw_depends_on_its_key_and_counter_alone():
    rows = torch.arange(50)[:, None]
    slots = torch.arange(40)[None, :]
    full = kr.normal(7, rows, slots, kr.TAG_NOISE)
    part = kr.normal(7, rows[[3, 41, 17]], slots[:, 5:30], kr.TAG_NOISE)
    assert torch.equal(part, full[[3, 41, 17], 5:30])
    one = kr.normal(7, torch.tensor(41), torch.tensor(12), kr.TAG_NOISE)
    assert float(one) == float(full[41, 12])
    # another key, tag or row gives other numbers
    assert not torch.equal(kr.normal(8, rows, slots, kr.TAG_NOISE), full)
    assert not torch.equal(kr.normal(7, rows, slots, kr.TAG_JITTER), full)
    # per-row keys: row g under key k is the scalar key k's row
    keys = torch.tensor([[5], [9]])
    both = kr.uniform(keys, torch.zeros(1, 8, dtype=I64),
                      torch.arange(8)[None, :], kr.TAG_ADC)
    for g, k in enumerate((5, 9)):
        assert torch.equal(both[g], kr.uniform(k, torch.zeros(8, dtype=I64),
                                               torch.arange(8), kr.TAG_ADC))


def test_keys_are_taken_modulo_two_to_the_64():
    slots = torch.arange(6)
    rows = torch.zeros(6, dtype=I64)
    for k in (-1, -2**40 - 3, 2**63 - 1):
        a = kr.uniform(k, rows, slots, kr.TAG_TRIAL)
        b = kr.uniform(k % 2**64, rows, slots, kr.TAG_TRIAL)
        assert torch.equal(a, b)
        if -2**63 <= k < 2**63:
            c = kr.uniform(torch.tensor(k), rows, slots, kr.TAG_TRIAL)
            assert torch.equal(a, c)
    with pytest.raises(ValueError, match="32 bits"):
        kr.check_index("slot", 2**32)
    kr.check_index("slot", 2**32 - 1)


def test_uniforms_and_normals_have_their_distributions():
    rows = torch.arange(400)[:, None]
    slots = torch.arange(500)[None, :]
    u = kr.uniform(3, rows, slots, kr.TAG_JITTER)
    assert bool(((u >= 0) & (u < 1)).all())
    # 53-bit grid: u · 2^53 is an integer
    assert torch.equal(u * 2.0**53, torch.floor(u * 2.0**53))
    n = u.numel()
    assert abs(float(u.mean()) - 0.5) < 4 * math.sqrt(1 / 12 / n)
    z = kr.normal(3, rows, slots, kr.TAG_NOISE)
    assert bool(torch.isfinite(z).all())
    assert abs(float(z.mean())) < 4 / math.sqrt(n)
    assert abs(float(z.std()) - 1.0) < 0.01
    # the fraction beyond 2σ: 4.55 %
    assert abs(float((z.abs() > 2).double().mean()) - 0.0455) < 0.003


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card half of the keyed stream "
                    "runs on the card only")
    return torch.device("cuda")


def test_cuda_words_equal_the_cpu_words(cuda):
    rng = np.random.default_rng(1)
    c = [torch.as_tensor(rng.integers(0, 2**32, 5000, dtype=np.uint64)
                         .astype(np.int64)) for _ in range(4)]
    k0, k1 = (int(x) for x in rng.integers(0, 2**32, 2, dtype=np.uint64))
    cpu = kr.philox4x32(*c, k0, k1)
    card = kr.philox4x32(*(x.to(cuda) for x in c), k0, k1)
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())
    for ctr, key, want in KNOWN_ANSWERS:
        got = kr.philox4x32(*(w.to(cuda) for w in _words(*ctr)), *key)
        assert [int(w) for w in got] == list(want)
    rows = torch.arange(64)[:, None]
    slots = torch.arange(300)[None, :]
    u_cpu = kr.uniform(11, rows, slots, kr.TAG_NOISE)
    u_card = kr.uniform(11, rows.to(cuda), slots.to(cuda), kr.TAG_NOISE)
    assert torch.equal(u_cpu, u_card.cpu())
    z_cpu = kr.normal(11, rows, slots, kr.TAG_NOISE)
    z_card = kr.normal(11, rows.to(cuda), slots.to(cuda), kr.TAG_NOISE)
    # the uniforms are equal; log and cos may differ by an ulp
    np.testing.assert_allclose(z_card.cpu().numpy(), z_cpu.numpy(),
                               rtol=1e-14, atol=1e-15)
