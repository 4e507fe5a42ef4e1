"""The port's probe kernels' plain versions against the Pallas probes.

`tools/pallas_probe.py` and `tools/pallas_probe2.py` run their kernel on
the default backend when imported, so the test never imports them: it
takes the `kernel` function out of each file with `ast` and calls it
through `pl.pallas_call(..., interpret=True)` with the specs of the file's
`run`. Every value is an int32, so every comparison is exact (tolerance
0), including where the sums wrap around.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from picsong_tpu_torch.tools import probe, probe2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pallas_kernel(name: str):
    """The `kernel` function of tools/<name>, compiled from its source."""
    path = os.path.join(REPO, "tools", name)
    tree = ast.parse(open(path).read(), path)
    keep = [node for node in tree.body
            if (isinstance(node, ast.FunctionDef) and node.name == "kernel")
            or (isinstance(node, ast.Assign)
                and all(isinstance(t, ast.Name) and t.id in ("C", "CAP")
                        for t in node.targets))]
    namespace = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"),
         namespace)
    return namespace["kernel"]


def _interpret(name: str, tape: np.ndarray, scalars: np.ndarray) -> np.ndarray:
    """tools/<name>'s `run`, in interpret mode."""
    return np.asarray(pl.pallas_call(
        _pallas_kernel(name),
        out_shape=jax.ShapeDtypeStruct((32, 128), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((128, 128), jnp.int32)],
        interpret=True,
    )(jnp.asarray(tape), jnp.asarray(scalars)))


def _probe_case(case: str):
    if case.startswith("seed"):
        return probe.inputs(int(case[4:]))
    tape, base = probe.edge_inputs()
    if case == "edge_base0":
        base[:3] = [0, 511, 384]                   # row 0 not doubled
    return tape, base


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "edge_base0",
                                  "edge_base511"])
def test_probe_plain_matches_pallas_interpret(case):
    tape, base = _probe_case(case)
    want = _interpret("pallas_probe.py", tape, base)
    got = probe.run(torch.from_numpy(tape), torch.from_numpy(base))
    assert got.dtype == torch.int32 and got.shape == (32, 128)
    assert np.array_equal(got.numpy(), want)


def _probe2_case(case: str):
    if case.startswith("seed"):
        return probe2.inputs(int(case[4:]))
    return probe2.edge_inputs()


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "edge"])
def test_probe2_plain_matches_pallas_interpret(case):
    tape, amt = _probe2_case(case)
    want = _interpret("pallas_probe2.py", tape, amt)
    got = probe2.run(torch.from_numpy(tape), torch.from_numpy(amt))
    assert got.dtype == torch.int32 and got.shape == (32, 128)
    assert np.array_equal(got.numpy(), want)


def test_probe2_is_jnp_roll_not_the_tools_host_check():
    """pltpu.roll in interpret mode rolls as jnp.roll; the host check of
    tools/pallas_probe2.py rolls by -shift and disagrees with the kernel."""
    tape, amt = probe2.inputs(0)
    got = probe2.run(torch.from_numpy(tape), torch.from_numpy(amt)).numpy()
    flat = tape.reshape(128, 4096)

    def expect(sign):
        stage = np.empty((128, 128), np.int64)
        for n, a in enumerate(amt):
            slab = flat[n, (a // 1024) * 1024:(a // 1024 + 1) * 1024]
            rot = np.roll(slab.reshape(8, 128), sign * ((a % 1024) // 128),
                          axis=0)
            stage[n] = np.roll(rot, sign * (a % 128), axis=1)[0]
        t = stage.T
        rank = np.abs(t[:32]) % 8
        return t[rank, np.arange(128)[None, :]] + t[:32]

    assert np.array_equal(got, expect(+1))
    assert not np.array_equal(got, expect(-1))     # the tool's host check


def test_probe_wrappers_refuse_inputs_outside_the_domain():
    tape, base = (torch.from_numpy(a) for a in probe.inputs(0))
    for bad in (-1, 512):
        b = base.clone()
        b[5] = bad
        with pytest.raises(ValueError, match="base must lie"):
            probe.run(tape, b)
    with pytest.raises(TypeError, match="int32"):
        probe.run(tape.long(), base)
    with pytest.raises(ValueError, match="contiguous"):
        probe.run(tape[:, :256], base)
    tape2, amt = (torch.from_numpy(a) for a in probe2.inputs(0))
    for bad in (-1, 4096):
        a = amt.clone()
        a[0] = bad
        with pytest.raises(ValueError, match="amt must lie"):
            probe2.run(tape2, a)
    with pytest.raises(ValueError, match="shape|contiguous"):
        probe2.run(tape2.reshape(128, 32, 128), amt)


def _read_tape_words(module, tape, arg):
    """Mask of the tape words the probe's output depends on, from the
    definitions in the kernels' headers."""
    mask = np.zeros(tape.shape, dtype=bool)
    n = np.arange(128)
    if module is probe:
        mask[:32, :128] = True
        v = tape[0, :128].astype(np.int64)
        rank = (64 * ((v >> 1) + (v > 100))) & 127
        mask[n, arg // 128 * 128 + rank] = True
    else:
        a = arg.astype(np.int64)
        rows = (-((a % 1024) // 128)) % 8
        for j in range(32):
            mask[4 * n + a // 1024, rows, (j - a % 128) % 128] = True
    return mask


@pytest.mark.parametrize("module", [probe, probe2])
@pytest.mark.parametrize("case", ["probe_inputs", "edges"])
def test_probe_bound_charges_the_words_the_output_reads(module, case):
    """`words_moved` counts the tape words the output depends on (words
    outside them change nothing), the second input and the output."""
    tape, arg = module.inputs(0) if case == "probe_inputs" else \
        module.edge_inputs()
    mask = _read_tape_words(module, tape, arg)
    t, a = torch.from_numpy(tape), torch.from_numpy(arg)
    assert module.words_moved(t, a) == mask.sum() + arg.size + 32 * 128
    noise = np.random.default_rng(5).integers(
        -2**31, 2**31, size=tape.shape, dtype=np.int64).astype(np.int32)
    other = torch.from_numpy(np.where(mask, tape, noise))
    assert torch.equal(module.plain(other, a), module.plain(t, a))
    # K3's 64 accumulation adds are one shift (equal mod 2^32), so both
    # probes move more than they compute
    bound, by = module.bound_ms(t, a)
    assert bound > 0 and by == "bytes"


@pytest.mark.parametrize("module", [probe, probe2])
def test_probe_entry_points_run_on_cpu(module, capsys):
    before = module.LAUNCHES
    assert module.main(["--device", "cpu", "--calls", "3"]) == 0
    out = capsys.readouterr().out
    assert "steady:" in out and "out[0,:4] =" in out
    assert module.LAUNCHES == before
