"""A configuration names its model module (``perfbench/models/<model>.py``).

* The Llama cells read as they did before the model module existed: at
  the small sizes of ``conftest.py``, on two seeds, the weights, the token
  pool, the batches the check draws, the program's and the reference's
  scores, the float8 control's and the two numbers compared equal the
  ones computed on commit ce6be71 (``perfbench/weights.py``,
  ``program.py``, ``spec.py`` and ``reference/lm.py`` as they were then),
  bit for bit; so do the full-size work counts the traced readers divide by.
* A model of another kind joins as files only: a configuration, its module,
  a traffic mix and limits written under a fresh root, driven through
  ``spec.load_cell`` and ``harness.run_cell`` unchanged.
* A configuration without a ``model`` key is refused.
"""
import hashlib
import json
import time

import pytest
import torch

from perfbench import check, harness, job, spec, tracing
from perfbench.weights import make_tokens

CELLS = ["yi-6b.score-4k", "h2o-danube-3-4b.score-4k", "yi-6b.score-512"]
MATRICES = ("wq", "wk", "wv", "wo", "gate", "up", "down")
CPU = torch.device("cpu")

#: the full-size work counts of a batch: (batch_flops, flash_launch_bound_s)
WORK = {
    "yi-6b.score-4k": (103802917093376, 0.0002780030493508595),
    "h2o-danube-3-4b.score-4k": (69080690196480, 0.0002606278587664307),
    "yi-6b.score-512": (96106335698944, 4.50731176119403e-05),
}
#: (weights, token pool, program scores, reference scores, float8 control's scores)
#: as SHA-256, the batches checked and the two numbers compared, by (cell, seed)
PARENT = {
    ("yi-6b.score-4k", 7): (
        "489c5e265ae46eb7ad7ada92c775454cf68b43cdae3c989d21222dc55546d693",
        "511d1762435751a4ae84aa1ba4b6ab629637e72d9df66521610a201e65027880",
        "fc668ccf3517c0ea7d1f3da22fd02e425044cfe5e3556a9cb916535b74acd792",
        "4ee86d4984c97ce3b3e61031659cd86aa1feadb9584e76f4586857e78fcb2a42",
        "e9af59afcb717a331694f85d36d0521b8b243a7486d09a07e411999328ca9beb",
        [2, 5], 0.03823709487915039, 0.00843526264454456),
    ("yi-6b.score-4k", 2**31 + 101): (
        "c5c347b202a0e52b4a02300903cd6a21aed77eb5121e1f618a789d365c04e7b2",
        "952f5b08a5d36e5c3afacc8ed82013e9d09b6021bd7f4ccea79365c99bbafff8",
        "f948d4f58bbc7ebc06eb34ca9ee8dd61e67010b1e3c3d41f89828959837baaa8",
        "25116b44813adb396d92f73d9bd880e2c7229fc58f3794698d02299c813e2d07",
        "facb53b8da154101883b0b648ce0e1c185f1b53a8f95726ef3c1e6d443aafe56",
        [3, 4], 0.030427932739257812, 0.00741547980207078),
    ("h2o-danube-3-4b.score-4k", 7): (
        "c983e3c9b1bbeb5aafcc9fbb87504d9548366160243d434f0d018149c3325fd7",
        "511d1762435751a4ae84aa1ba4b6ab629637e72d9df66521610a201e65027880",
        "9594366bcb0104fab3f7e5d12f25d93a516a6091f8401c024b3d606293d2db28",
        "5d055c3f28439af90b3f52bac8d530838509b142bb7eb363503006b2d27bf938",
        "504c639352fc41038894bf111831cea5c7acd2f8a5e196edc651d434ad00e8d4",
        [2, 5], 0.033573150634765625, 0.007873063391827523),
    ("h2o-danube-3-4b.score-4k", 2**31 + 101): (
        "a270818bb74607b884332aca6b843e72d9b5113f93dd2becf5e09481b679179f",
        "952f5b08a5d36e5c3afacc8ed82013e9d09b6021bd7f4ccea79365c99bbafff8",
        "e49182e722adff50b7e1c31efc0a92f307b5e9f75dabe5da6db0bb4af1d52e4f",
        "f109ad19b9263a6a02602db2167e42cafa118f1c8a00f51a210c5c21ce539e70",
        "2dca9dc4f70505e3bf9c97a6cc549b2fe2f928578e19df32ad1ac2cf6d87667b",
        [3, 4], 0.028184890747070312, 0.007868774393771557),
    ("yi-6b.score-512", 7): (
        "489c5e265ae46eb7ad7ada92c775454cf68b43cdae3c989d21222dc55546d693",
        "56ef63026b016b1313e068374ef38ccb50788a4f102d972445e2a8901fdca1b8",
        "1016236be7ce91be86ff6597c171bc5635b6a817c0d8880b63f95df655ffe331",
        "7c2f9565230830d983e17aaf2308bdbcac4fbc2fb865a4aa74ca8f789d67c2d7",
        "464dbf591d9b677dea9b6d16777f4874692d9e7393a9259a810f3a6da5bccfe9",
        [2, 5], 0.041136741638183594, 0.007934735493457063),
    ("yi-6b.score-512", 2**31 + 101): (
        "c5c347b202a0e52b4a02300903cd6a21aed77eb5121e1f618a789d365c04e7b2",
        "1fd60f1c7e44088502f288d86fd28aaa40dcddbdc162bff0f350dcdfd3268528",
        "ca0c7b5155bf01ce667661e13794e11dd36ec846a9c09da1e9daf9fa6c35e195",
        "31fa4bdd8834ae316d90ebab352f56942dc86a5934d73a3121fd03395cdcbfef",
        "2886d743a69334991324cc59e76e0074e5c6731e57238fcad5d5368a6fc12210",
        [3, 4], 0.04336404800415039, 0.00806888351415066),
}


def sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def weight_tensors(w):
    """Every matrix in the order the buffer holds them, then the norm scales
    in the order they are drawn."""
    layers = w["layers"]
    return ([w["embed"]] + [x[k] for x in layers for k in MATRICES] + [w["head"]]
            + [n for x in layers for n in (x["norm1"], x["norm2"])] + [w["final_norm"]])


@pytest.fixture
def one_thread():
    """One CPU thread: a float32 product's sums then come in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", CELLS)
def test_the_work_counts_are_the_parents(workload):
    cell = spec.load_cell(workload)
    work = harness.work(cell)
    assert (work.batch_flops, work.flash_launch_bound_s) == WORK[workload]


@pytest.mark.parametrize("workload, seed", list(PARENT))
def test_the_readings_are_the_parents(workload, seed, small_cell, unguarded, one_thread):
    cell = small_cell(workload)
    model_def = cell.model
    shape = model_def.ref_shape(cell.config)
    weights = model_def.make_weights(cell.config, seed, CPU)
    pool = make_tokens(shape.vocab, int(cell.traffic["pool_batches"]), cell.rows,
                       cell.seq_len, seed, CPU)
    picked = check.sample(seed, len(pool), int(cell.traffic["check_batches"]))
    rows = torch.cat([pool[i] for i in picked])
    model = model_def.build(model_def.port_config(cell.config), weights)
    got = torch.cat([job.score_batch(model.forward, pool[i]) for i in picked])
    want = model_def.score_rows(weights, rows, shape)
    control = model_def.score_rows(weights, rows, shape, model_def.control())
    readings = check.readings(got.numpy(), want.numpy())
    assert (sha(weight_tensors(weights)), sha([pool.batches]), sha([got]), sha([want]),
            sha([control]), picked, readings["max_gap"], readings["mean_gap"]
            ) == PARENT[(workload, seed)]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_names_its_model_module(workload):
    cell = spec.load_cell(workload)
    assert cell.config["model"] == "llama"
    assert cell.model.__file__ == str(spec.HERE / "models" / "llama.py")


TOY_MODULE = '''"""A toy of the MLA + MoE kind: a leading dense layer, then layers whose
FFN is a stack of experts (E, d, f) mixed by a softmax router; each layer
mixes positions through a latent of its own width, normed at that width,
by a causal mean; no flash launch.  The program runs it in bf16, the
reference in float32."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from perfbench.weights import generator, matrices, norm_scales


@dataclass(frozen=True)
class Shape:
    d_model: int
    latent: int
    d_ff: int
    d_expert: int
    experts: int
    layers: int
    dense_layers: int
    vocab: int
    eps: float

    def dense(self, i: int) -> bool:
        return i < self.dense_layers


def ref_shape(config):
    return Shape(config["hidden_size"], config["kv_lora_rank"], config["intermediate_size"],
                 config["moe_intermediate_size"], config["n_routed_experts"],
                 config["num_hidden_layers"], config["first_k_dense_replace"],
                 config["vocab_size"], config["rms_norm_eps"])


def layer_plan(s, i):
    d, r, e, f = s.d_model, s.latent, s.experts, s.d_expert
    plan = [("down_kv", (d, r), d ** -0.5), ("up_kv", (r, d), r ** -0.5)]
    if s.dense(i):
        return plan + [("gate", (d, s.d_ff), d ** -0.5), ("up", (d, s.d_ff), d ** -0.5),
                       ("down", (s.d_ff, d), s.d_ff ** -0.5)]
    return plan + [("router", (d, e), d ** -0.5), ("gate", (e, d, f), d ** -0.5),
                   ("up", (e, d, f), d ** -0.5), ("down", (e, f, d), f ** -0.5)]


def make_weights(config, seed, device):
    s = ref_shape(config)
    plans = [layer_plan(s, i) for i in range(s.layers)]
    gen = generator(seed, device)
    views = iter(matrices(gen, [((s.vocab, s.d_model), s.d_model ** -0.5)]
                          + [(dims, scale) for p in plans for _, dims, scale in p]
                          + [((s.d_model, s.vocab), s.d_model ** -0.5)], device))
    weights = {"embed": next(views)}
    weights["layers"] = [{key: next(views) for key, _, _ in p} for p in plans]
    weights["head"] = next(views)
    norms = norm_scales(gen, (2 * s.layers + 1, s.d_model), device)
    latent_norms = norm_scales(gen, (s.layers, s.latent), device)
    for i, w in enumerate(weights["layers"]):
        w.update(norm_mix=norms[2 * i], norm_ffn=norms[2 * i + 1], norm_kv=latent_norms[i])
    weights["final_norm"] = norms[-1]
    return weights


def same(t):
    return t


def float8(t):
    return t.to(torch.float8_e4m3fn).to(t.dtype)


def rms(x, scale, eps):
    x32 = x.float()
    return (x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps) * scale).to(x.dtype)


def logits(weights, tokens, s, dtype, rnd):
    def mm(x, w):
        return rnd(x) @ rnd(w.to(dtype))

    silu = torch.nn.functional.silu
    h = weights["embed"][tokens].to(dtype)
    count = torch.arange(1, tokens.shape[1] + 1, device=tokens.device)[:, None]
    for i, w in enumerate(weights["layers"]):
        z = rms(mm(rms(h, w["norm_mix"], s.eps), w["down_kv"]), w["norm_kv"], s.eps)
        h = h + mm((z.float().cumsum(1) / count).to(dtype), w["up_kv"])
        x = rms(h, w["norm_ffn"], s.eps)
        if s.dense(i):
            h = h + mm(silu(mm(x, w["gate"])) * mm(x, w["up"]), w["down"])
        else:
            p = torch.softmax(mm(x, w["router"]).float(), -1).to(dtype)  # (B, S, E)
            x = x[:, None]  # (B, 1, S, d) against (E, d, f)
            y = mm(silu(mm(x, w["gate"])) * mm(x, w["up"]), w["down"])  # (B, E, S, d)
            h = h + (p.transpose(1, 2)[..., None] * y).sum(1)
    return mm(rms(h, weights["final_norm"], s.eps), weights["head"])


class Toy(torch.nn.Module):
    def __init__(self, shape, weights):
        super().__init__()
        self.shape, self.weights = shape, weights

    def forward(self, tokens):
        with torch.no_grad():
            return logits(self.weights, tokens, self.shape, torch.bfloat16, same)


def port_config(config):
    if config["torch_dtype"] != "bfloat16":
        raise ValueError("the toy serves bf16")
    return ref_shape(config)


def build(cfg, weights):
    return Toy(cfg, weights)


def score_rows(weights, rows, shape, rounding=None):
    with torch.no_grad():
        logp = torch.log_softmax(logits(weights, rows, shape, torch.float32, rounding or same),
                                 -1)
        return logp[:, :-1].gather(-1, rows[:, 1:, None])[..., 0]


def control():
    return float8


def batch_flops(config, rows, seq_len):
    s = ref_shape(config)
    params = s.d_model * s.vocab + sum(
        2 * s.d_model * s.latent
        + (3 * s.d_model * s.d_ff if s.dense(i)
           else s.d_model * s.experts + 3 * s.experts * s.d_model * s.d_expert)
        for i in range(s.layers))
    return 2 * params * rows * seq_len


def flash_launch_bound_s(config, rows, seq_len):
    return None
'''

TOY_CONFIG = {
    "name": "toy-mla-moe", "model": "toy_mla_moe", "hidden_size": 32, "kv_lora_rank": 16,
    "intermediate_size": 64, "moe_intermediate_size": 24, "n_routed_experts": 4,
    "num_hidden_layers": 3, "first_k_dense_replace": 1, "vocab_size": 96,
    "rms_norm_eps": 1e-6, "torch_dtype": "bfloat16", "reduced": [],
}
TOY_CELL = "toy-mla-moe.score"
#: 2 * (32 x 96 head; 3 layers of 2 x 32 x 16; a dense 3 x 32 x 64; two
#: MoE layers of 32 x 4 + 3 x 4 x 32 x 24) = 61,952 a token, 64 tokens
TOY_BATCH_FLOPS = 2 * (3072 + 3 * 1024 + 6144 + 2 * (128 + 9216)) * 64


def write(path, data) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(data if isinstance(data, str) else json.dumps(data))


def toy_root(root, config=None):
    """A root holding the toy's configuration, module, traffic and limits
    and a BENCHMARK.json of one cell; the readers are the repository's."""
    bench = spec.benchmark()
    write(root / "BENCHMARK.json", dict(
        bench,
        configs=[{"name": TOY_CONFIG["name"], "source": "https://arxiv.org/abs/2405.04434",
                  "file": "perfbench/configs/toy-mla-moe.json", "reduced": [],
                  "why": "a leading dense layer, then experts"}],
        workloads=[{"name": TOY_CELL, "config": TOY_CONFIG["name"], "traffic": "score-toy",
                    "chips": 1, "why": "4 windows of 16 tokens a batch"}],
        per_layer=[dict(m, workloads=[TOY_CELL]) for m in bench["per_layer"]
                   if m["name"] in ("forward_mfu", "flash_roofline")]))
    write(root / "perfbench" / "configs" / "toy-mla-moe.json", config or TOY_CONFIG)
    write(root / "perfbench" / "models" / "toy_mla_moe.py", TOY_MODULE)
    write(root / "perfbench" / "traffic" / "score-toy.json", {
        "name": "score-toy", "kind": "score", "seq_len": 16, "tokens_per_batch": 64,
        "clients": 2, "pool_batches": 6, "warmup_batches": 1, "trace_batches": 2,
        "check_batches": 2})
    # sound runs read 0.018-0.031 and 0.0061-0.0067 on seeds 1-3 and 2**31 + 5,
    # the float8 control 0.23-0.44 and 0.079-0.092
    write(root / "perfbench" / "limits" / f"{TOY_CELL}.json",
          {"max_gap": {"limit": 0.1}, "mean_gap": {"limit": 0.03}})
    return root


def run(cell, make_forward=None, traced_run=False, seed=2**31 + 17):
    return harness.run_cell(cell, seed=seed, seconds=0.2, traced_run=traced_run, device=CPU,
                            t0=time.perf_counter(), make_forward=make_forward)


def half_batch(model, weights):
    """Half of the batch left out: the first half's rows stand in for the rest."""
    def forward(tokens):
        half = model.forward(tokens[: tokens.shape[0] // 2])
        return torch.cat([half, half])
    return forward


def test_a_model_of_another_kind_joins_as_files_only(tmp_path):
    cell = spec.load_cell(TOY_CELL, root=toy_root(tmp_path))
    assert cell.model.__file__ == str(tmp_path / "perfbench" / "models" / "toy_mla_moe.py")
    assert (cell.rows, cell.seq_len) == (4, 16)
    weights = cell.model.make_weights(cell.config, 3, CPU)
    assert weights["layers"][1]["gate"].shape == (4, 32, 24)
    assert weights["layers"][1]["norm_kv"].shape == (16,)
    result = run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 2
    broken = run(cell, make_forward=half_batch)
    assert not broken["correct"], broken["checks"]

    def control(model, weights):
        shape = cell.model.ref_shape(cell.config)
        return lambda tokens: cell.model.logits(weights, tokens, shape, torch.float32,
                                                cell.model.control())

    assert not run(cell, make_forward=control)["correct"]


def test_the_toy_is_read_by_the_same_readers(tmp_path):
    """A traced run on the CPU comes out correct, with no device operation
    to read; the readers, given a window with one kernel and the toy's
    work, read forward_mfu from the toy's FLOPs and find no flash launch."""
    cell = spec.load_cell(TOY_CELL, root=toy_root(tmp_path))
    result = run(cell, traced_run=True)
    assert result["correct"], result["checks"]
    work = harness.work(cell)
    assert (work.batch_flops, work.flash_launch_bound_s) == (TOY_BATCH_FLOPS, None)
    window = tracing.Window(start=0.0, window_s=0.010, batches=2, work=work,
                            kernels=[tracing.Op("nvjet_gemm", 0.0, 0.009)])
    got = tracing.read(window, spec.metric_readers(cell))
    assert got == {"forward_mfu": pytest.approx(100 * 2 * TOY_BATCH_FLOPS / (0.010 * 989e12))}


def test_a_configuration_without_a_model_module_is_refused(tmp_path):
    config = {k: v for k, v in TOY_CONFIG.items() if k != "model"}
    with pytest.raises(ValueError, match="names no model module"):
        spec.load_cell(TOY_CELL, root=toy_root(tmp_path, config))


@pytest.mark.parametrize("name, error", [("../toy_mla_moe", ValueError),
                                         ("mamba", FileNotFoundError)])
def test_a_model_module_that_is_not_there_is_refused(name, error, tmp_path):
    with pytest.raises(error):
        spec.load_cell(TOY_CELL, root=toy_root(tmp_path, dict(TOY_CONFIG, model=name)))
