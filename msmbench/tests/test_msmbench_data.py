"""The frames made from the seed: the same seed gives the same frames,
on the CPU here and on the card (``cuda``)."""

import pytest
import torch

from msmbench.data import basins


def _make(seed, device, out=None):
    return basins.frames(seed, 5000, 7, n_basins=30, dwell=64, noise=0.02,
                         device=device, out=out)


@pytest.mark.parametrize('seed', [0, 2 ** 31 + 12345, 2 ** 40 + 3])
def test_same_seed_same_frames(seed):
    a = _make(seed, torch.device('cpu'))
    b = _make(seed, torch.device('cpu'))
    assert a.shape == (5000, 7, 3) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, _make(seed + 1, torch.device('cpu')))


def test_written_into_host_buffer_chunk_by_chunk(monkeypatch):
    monkeypatch.setattr(basins, 'CHUNK', 777)
    whole = _make(9, torch.device('cpu'))
    out = torch.empty((5000, 7, 3))
    _make(9, torch.device('cpu'), out=out)
    assert torch.equal(out, whole)


def test_frames_sit_in_few_basins():
    X = _make(4, torch.device('cpu'))
    # consecutive frames mostly share a basin: differences of noise only
    step = (X[1:] - X[:-1]).abs().amax(dim=(1, 2))
    assert (step < 0.2).float().mean() > 0.95


def test_lengths_and_subsample():
    assert basins.lengths(3_215_000, 100_000) == [100_000] * 32 + [15_000]
    assert basins.lengths(14_680_000, 100_000) == [100_000] * 146 + [80_000]
    lens = basins.lengths(3_215_000, 100_000)
    sub = basins.subsample(lens, 10)
    assert len(sub) == 321_500
    assert sub[10_000].item() == 100_000 and sub[-1].item() == 3_214_990


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


@pytest.mark.cuda
def test_same_seed_same_frames_on_the_card(card):
    a = _make(2 ** 31 + 77, card)
    assert torch.equal(a, _make(2 ** 31 + 77, card))
    host = torch.empty((5000, 7, 3))
    _make(2 ** 31 + 77, card, out=host)
    assert torch.equal(host, a.cpu())
