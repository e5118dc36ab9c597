"""The port's ServeEngine against the JAX package's, on the CPU.

Mirrors tests/test_serve.py: a single request (also against the greedy
full-forward oracle), three requests on two slots (queueing and slot
reuse), slot reuse after completion, and sampling at a temperature.  Both
engines serve the same weights (the JAX init carried across with
``params_from_numpy``) in float32 compute, so the generated tokens must
be equal, not merely close.  The kernel route runs the port's kernels'
plain versions (CPU tensors) against the JAX Pallas kernels in interpret
mode.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import LM, params_from_numpy
from repro_torch.serve import Request, ServeConfig, ServeEngine

torch.set_num_threads(1)  # tiny tensors: extra threads only contend


@pytest.fixture(scope="module", params=[False, True], ids=["reference", "kernel"])
def served(request):
    flag = request.param
    jcfg = dataclasses.replace(jax_smoke_config("yi_6b"), use_flash_kernel=flag,
                               compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(get_smoke_config("yi_6b"), use_flash_kernel=flag,
                               compute_dtype=torch.float32)
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), pcfg, device="cpu")
    return jmodel, params, port


def run_both(served, prompts, *, max_batch, max_len=32, new=4, temperature=0.0, seed=0):
    jmodel, params, port = served
    jreqs = [JaxRequest(prompt=np.array(p, np.int32), max_new_tokens=new) for p in prompts]
    preqs = [Request(prompt=np.array(p, np.int32), max_new_tokens=new) for p in prompts]
    JaxServeEngine(jmodel, params, JaxServeConfig(max_batch=max_batch, max_len=max_len,
                                                  temperature=temperature)).generate(jreqs, seed=seed)
    ServeEngine(port, None, ServeConfig(max_batch=max_batch, max_len=max_len,
                                        temperature=temperature),
                device="cpu").generate(preqs, seed=seed)
    return [r.generated for r in preqs], [r.generated for r in jreqs]


def test_single_request_matches_jax_and_the_forward_oracle(served):
    got, want = run_both(served, [[1, 2, 3]], max_batch=2, new=5)
    assert got == want
    port = served[2]
    toks = [1, 2, 3]
    for _ in range(5):  # greedy through full forward passes
        toks.append(int(torch.argmax(port(torch.tensor([toks]))[0, -1])))
    assert got[0] == toks[3:]


def test_batched_requests_queue_and_reuse_slots_like_jax(served):
    """3 requests, 2 slots: queueing, slot reuse and stray writes on the
    idle slot all happen, and the tokens equal the JAX engine's."""
    prompts = [[5, 6], [9, 8, 7], [11]]
    got, want = run_both(served, prompts, max_batch=2)
    assert got == want
    solo = [run_both(served, [p], max_batch=2)[0][0] for p in prompts]
    assert got == solo  # concurrent requests are isolated


def test_slot_reuse_after_completion(served):
    got, want = run_both(served, [[1], [2]], max_batch=1, new=3)
    assert got == want and [len(g) for g in got] == [3, 3]
    assert got[1] == run_both(served, [[2]], max_batch=1, new=3)[0][0]


def test_max_len_stops_a_request_like_jax(served):
    """A prompt near max_len stops at max_len - 1 tokens in the slot."""
    got, want = run_both(served, [list(range(1, 12)), [4]], max_batch=2, max_len=14, new=8)
    assert got == want and len(got[0]) == 2


def test_temperature_sampling_draws_like_jax(served):
    got, want = run_both(served, [[3, 1], [7]], max_batch=2, new=6, temperature=0.8, seed=5)
    assert got == want


def test_engine_takes_params_as_a_state_dict(served):
    """params=state_dict assigns the weights into a fresh structure."""
    port = served[2]
    fresh = LM(port.cfg)
    engine = ServeEngine(fresh, port.state_dict(), ServeConfig(max_batch=1, max_len=16),
                         device="cpu")
    assert fresh.blocks[0]["attn"]["wq"]["w"].data_ptr() == \
        port.blocks[0]["attn"]["wq"]["w"].data_ptr()
    r = Request(prompt=np.array([2, 3], np.int32), max_new_tokens=3)
    engine.generate([r])
    assert r.generated == run_both(served, [[2, 3]], max_batch=1, max_len=16, new=3)[0][0]


def test_serve_launcher_runs_on_the_cpu():
    """``python -m repro_torch.launch.serve --smoke --device cpu``."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-6b", "--smoke",
         "--device", "cpu", "--prompts", "2", "--new-tokens", "3"],
        capture_output=True, text=True, cwd=root, timeout=300,
        env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == ["req0", "req1"]
    assert all(len(line.split("->")[1].strip().strip("[]").split(",")) == 3 for line in lines)
