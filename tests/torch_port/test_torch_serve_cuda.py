"""The port's serving engine on a CUDA card: the ``tiny`` engine's tokens
equal the port's full-forward greedy on the card, and the paths that route
writes to the trash block (padding positions, inactive slots, CoW padding,
spill reloads) run without a device-side assert.  Every case carries the
``cuda`` marker and skips without a card.  The file imports no JAX, so on a
machine without it run

    python -m pytest --noconftest -p no:cacheprovider tests/torch_port/test_torch_serve_cuda.py
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import llama
from horovod_tpu_torch.serve import ServeConfig, ServeEngine


def _model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return llama.init(llama.CONFIGS["tiny"],
                      torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")


def _greedy(model, prompt, n_new):
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            logits = model(torch.tensor([ids], device="cuda"))
            ids.append(int(logits[0, -1].float().argmax()))
    return ids[len(prompt):]


def _prompts():
    rng = np.random.RandomState(5)
    system = rng.randint(0, 256, 9).tolist()
    return [system + [11, 12, 11, 12], system + [11, 12, 11, 99],
            system + rng.randint(0, 256, 3).tolist(),
            rng.randint(0, 256, 17).tolist()]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(),
    dict(prefill_chunk=5, spec_k=3),
    dict(prefix_cache=False, spec_decode=False),
    dict(max_slots=1, cache_blocks=12, spill_blocks=8, spec_decode=False),
])
def test_engine_matches_greedy_on_card(kw):
    """Mixed-length requests with shared prefixes (CoW copies, padding
    positions, free slots): every request's tokens equal greedy through
    the full forward on the card, over a cold and a warm wave."""
    model = _model()
    cfg = dict(max_slots=3, block_size=4, cache_blocks=40, max_seq_len=48,
               max_batch_tokens=16, prefill_chunk=8)
    cfg.update(kw)
    engine = ServeEngine(model, ServeConfig(**cfg))
    assert engine.device.type == "cuda"
    prompts = _prompts()
    for wave in ("cold", "warm"):
        reqs = [engine.submit(p, 6, req_id=f"{wave}{i}")
                for i, p in enumerate(prompts)]
        engine.flush()
        torch.cuda.synchronize()  # a device-side assert surfaces here
        for p, r in zip(prompts, reqs):
            assert r.state == "done" and r.out_tokens == _greedy(model, p, 6)
    stats = engine.stats()
    if engine.cfg.prefix_cache:
        assert stats["prefix_cache"]["hits"] >= 1
    if engine.cfg.spill_blocks:
        assert stats["spill"]["spilled_total"] >= 1


@pytest.mark.cuda
def test_dropped_writes_land_in_the_trash_block_on_card():
    """apply_cached with padding positions, an inactive slot with a stale
    row and -1 entries, and copy_blocks with padding, on the card: only the
    valid cells of blocks 0..num_blocks-1 change."""
    model = _model()
    nb, bs = 8, 4
    cache = llama.init_cache(model.cfg, nb, bs, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for pool in cache.values():
        pool[:, :nb] = torch.randn(pool[:, :nb].shape, generator=gen,
                                   device="cuda")
    before = {n: p.clone() for n, p in cache.items()}
    llama.copy_blocks(cache, torch.tensor([2, 0, 0], device="cuda"),
                      torch.tensor([nb, nb, nb], device="cuda"))
    bt = torch.tensor([[3, 6, -1], [2, 5, 7]], dtype=torch.int32,
                      device="cuda")
    toks = torch.randint(0, 256, (2, 8), generator=gen, device="cuda")
    model.apply_cached(toks, cache, bt, torch.tensor([1, 0], device="cuda"),
                       torch.tensor([2, 0], device="cuda"))
    torch.cuda.synchronize()
    for name, pool in cache.items():
        diff = (pool[:, :nb] != before[name][:, :nb]).any(dim=(0, 3, 4))
        cells = {(int(b), int(o))
                 for b, o in zip(*torch.nonzero(diff, as_tuple=True))}
        assert cells == {(3, 1), (3, 2)}
