"""The port's LM serving engine and serving launcher
(``repro_torch.serve.engine``, ``repro_torch.launch.serve``) on the CPU.

``ServeEngine`` on weights carried across from the reference
(``params_from_reference``) must emit exactly the reference engine's tokens
for every request mix here, including the reference's shared-``cache_len``
step (prompts of different lengths, a request admitted mid-run into a
freed slot), an ``eos_id`` and runs cut by ``s_max``. The launcher runs in
each dispatch mode and writes its trace and metrics files.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import model as RM
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as TM
from repro_torch.serve import ServeEngine


@dataclasses.dataclass(frozen=True)
class Mix:
    arch: str
    slots: int
    s_max: int
    prompts: tuple  # prompt lengths, in submission order
    new: tuple  # max_new_tokens of each request
    eos_from: int = -1  # eos_id: the reference's token at this index of request 0's output


MIXES = {
    # tests/test_serve.py::test_serve_engine_decode
    "serve_decode": Mix("smollm-135m", 2, 64, (8, 8, 8), (6, 6, 6)),
    # ragged prompts and budgets: slots share the first active slot's
    # cache_len, and requests 2-4 are admitted mid-run into freed slots
    "ragged": Mix("qwen3-14b", 2, 64, (5, 11, 3, 9, 7), (3, 7, 5, 2, 6)),
    "eos": Mix("chatglm3-6b", 3, 64, (6, 10, 4, 8), (12, 12, 12, 12), eos_from=3),
    # s_max cuts requests: cache_len >= s_max - 1 ends them; a prompt of
    # s_max tokens writes its decode at the clamped last position
    "s_max": Mix("starcoder2-15b", 2, 16, (12, 16, 5, 14), (10, 10, 10, 10)),
    # paligemma's decoder (MQA, tied head) fed tokens only, as the engine does
    "mqa_tied": Mix("paligemma-3b", 2, 32, (4, 9, 6), (5, 4, 6)),
    # MoE with GQA and qk_norm: every slot's token routes, empty slots too
    "moe_ragged": Mix("qwen3-moe-235b-a22b", 2, 64, (5, 11, 3, 9), (3, 7, 5, 2)),
    "moe_three_slots": Mix("qwen3-moe-235b-a22b", 3, 32, (12, 7, 12, 4), (6, 4, 8, 5)),
    # MLA + MoE: the packed cache, and an s_max cut with its clamped write
    "mla_decode": Mix("deepseek-v2-lite-16b", 2, 64, (8, 8, 8), (6, 6, 6)),
    "mla_s_max": Mix("deepseek-v2-lite-16b", 2, 16, (12, 16, 5, 14), (10, 10, 10, 10)),
    # SSM prompts are chunk multiples or shorter than a chunk (zamba2: 16,
    # rwkv6: 8); the states of every slot advance at each step
    "hybrid": Mix("zamba2-1.2b", 2, 64, (16, 16, 16), (6, 6, 6)),
    "hybrid_ragged": Mix("zamba2-1.2b", 2, 64, (32, 16, 12, 32), (5, 7, 4, 6)),
    "rwkv": Mix("rwkv6-7b", 2, 64, (8, 8, 8), (6, 6, 6)),
    "rwkv_ragged": Mix("rwkv6-7b", 3, 64, (16, 24, 8, 16), (7, 3, 5, 4)),
}


def _run(engine, mix: Mix, prompts):
    for rid, (p, n) in enumerate(zip(prompts, mix.new)):
        engine.submit(rid, p, max_new_tokens=n)
    return engine.run()


def _margins(monkeypatch, engine) -> dict:
    """(rid, token index) → the port's top-2 logit margin where the engine
    chose that token, read from the model calls it makes."""
    out, prefill, decode = {}, TM.prefill, TM.decode_step

    def top2(logits):
        t = logits[:, 0].topk(2, dim=-1).values
        return (t[:, 0] - t[:, 1]).tolist()

    def pre(*a):
        logits, cache = prefill(*a)
        req = next(s for s in engine.slots if s is not None and not s.out_tokens)
        out[(req.rid, 0)] = top2(logits)[0]
        return logits, cache

    def dec(*a):
        logits, cache = decode(*a)
        for s, m in zip(engine.slots, top2(logits)):
            if s is not None:
                out[(s.rid, len(s.out_tokens))] = m
        return logits, cache

    monkeypatch.setattr(TM, "prefill", pre)
    monkeypatch.setattr(TM, "decode_step", dec)
    return out


@pytest.mark.parametrize("name", sorted(MIXES))
def test_engine_emits_the_reference_tokens(name, monkeypatch):
    mix = MIXES[name]
    cfg = get_smoke_config(mix.arch)
    if cfg.input_mode == "vlm":  # the engine's prefill takes tokens only
        cfg = dataclasses.replace(cfg, input_mode="tokens", num_image_tokens=0)
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    model = TM.params_from_reference(jax.tree.map(np.asarray, params), cfg, "cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in mix.prompts]
    eos = None
    if mix.eos_from >= 0:
        eos = _run(RefEngine(cfg, params, mix.slots, mix.s_max), mix, prompts)[0][mix.eos_from]
    ref = _run(RefEngine(cfg, params, mix.slots, mix.s_max, eos), mix, prompts)
    port_engine = ServeEngine(cfg, model, mix.slots, mix.s_max, eos)
    margins = _margins(monkeypatch, port_engine)
    port = _run(port_engine, mix, prompts)
    for rid in sorted(ref):
        j = next((j for j, (a, b) in enumerate(zip(port.get(rid, []), ref[rid])) if a != b), None)
        assert j is None, (f"request {rid} token {j}: port {port[rid][j]}, reference "
                           f"{ref[rid][j]}; the port's top-2 margin there "
                           f"{margins.get((rid, j))}")
    assert port == ref
    assert set(port) == set(range(len(prompts)))
    if name == "eos":
        assert any(len(t) < n and t[-1] == eos for t, n in zip(port.values(), mix.new))
    if name == "s_max":
        assert any(len(t) < n for t, n in zip(port.values(), mix.new))
    assert not port_engine.queue and all(s is None for s in port_engine.slots)


def test_engine_needs_the_models_device():
    cfg = get_smoke_config("smollm-135m")
    model = TM.init_params(torch.Generator("cpu").manual_seed(0), cfg, "cpu")
    eng = ServeEngine(cfg, model)  # the engine runs where the model lies
    assert eng.device == torch.device("cpu")
    assert all(t.device == eng.device for seg in eng.cache for t in seg)
    model.blocks[0].to("meta")
    with pytest.raises(ValueError, match="model parameters on"):
        ServeEngine(cfg, model)
    with pytest.raises(ValueError, match="unsupported device"):
        ServeEngine(cfg, model.to("meta"))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b", "zamba2-1.2b",
                                  "rwkv6-7b"])
def test_launcher_serves_moe_and_ssm_archs_as_the_reference_does(arch, capsys):
    """The launcher's LM half prefills 12-token prompts: MoE, MLA and
    zamba2 (its smoke chunk, 16, covers them) serve; rwkv6's smoke chunk is
    8, and its prefill raises, as the reference's engine does."""
    cfg = get_smoke_config(arch)
    ref_engine = RefEngine(cfg, RM.init_params(jax.random.PRNGKey(0), cfg), 4, 128)
    ref_engine.submit(0, np.zeros(12, np.int32), max_new_tokens=2)
    argv = ["--arch", arch, "--device", "cpu", "--requests", "2", "--corpus", "200"]
    if arch == "rwkv6-7b":
        with pytest.raises(AssertionError, match="chunk multiple"):
            ref_engine.run()
        with pytest.raises(ValueError, match="multiple of the chunk"):
            launch_serve.main(argv)
        return
    assert len(ref_engine.run()[0]) == 2
    served = launch_serve.main(argv)
    assert sorted(served["tokens"]) == [0, 1]
    assert all(len(t) == 8 and all(0 <= x < cfg.vocab_size for x in t)
               for t in served["tokens"].values())
    assert "served 2 requests, 16 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["serial", "replica", "spmd"])
def test_launcher_runs_each_dispatch_mode(mode, tmp_path, capsys):
    trace, metrics = tmp_path / "trace.jsonl", tmp_path / "metrics.txt"
    served = launch_serve.main(["--device", "cpu", "--requests", "4", "--corpus", "200",
                                "--dispatch-mode", mode, "--policy", "adaptive",
                                "--resident-frac", "0.5",
                                "--trace-out", str(trace), "--metrics-out", str(metrics)])
    # request i asked for the 3 nearest to row i + 0.01: ascending, each the
    # exact distance of its id
    corpus = served["corpus"]
    ids = np.stack([r.ids for r in served["search"]])
    dists = np.stack([r.dists for r in served["search"]])
    assert ids.shape == (4, 3) and (np.diff(dists, axis=1) >= 0).all()
    q = corpus[:4] + 0.01
    exact = ((q[:, None].astype(np.float64) - corpus[ids]) ** 2).sum(-1)
    np.testing.assert_allclose(dists, exact, rtol=1e-5, atol=1e-5)
    assert sorted(served["tokens"]) == [0, 1, 2, 3]
    out = capsys.readouterr().out
    assert "served 4 requests, 32 tokens" in out and "tok/s on CPU" in out
    assert "policy[adaptive]" in out and "memory: pq=" in out
    assert trace.stat().st_size > 0 and metrics.stat().st_size > 0
    assert "wrote metrics exposition" in out
