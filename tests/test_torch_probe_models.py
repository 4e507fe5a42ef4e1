"""NumPy models of the probe kernels' work split (`csrc/probe.cu`,
`csrc/probe2.cu`) against their plain versions and the Pallas probes.

Each model computes what one lane of one warp of the kernel loads,
exchanges and stores, in the kernel's order, and is held exactly
(tolerance 0, int32) to `plain` and to the Pallas kernel in interpret mode
on the probes' own inputs, seeds 1 and 2 and the edge inputs. K3 folds its
64 wrapping adds into one shift; a test holds `(v << 6) mod 2^32` to the
64 adds at the int32 edges.
"""

import os

import numpy as np
import pytest
import torch

from picsong_tpu_torch import kernels
from picsong_tpu_torch.kernels import BYTES_PER_S
from picsong_tpu_torch.tools import kernel_ab, probe, probe2
from test_torch_probes import _interpret, _probe2_case, _probe_case

U32 = np.uint32
LANES = 32


def _accumulated(v: np.ndarray) -> np.ndarray:
    """K3's `accumulated`: ((v >> 1) + (v > 100)) << 6 in uint32."""
    step = (v.astype(np.int32) >> 1).astype(U32) + (v > 100).astype(U32)
    return step << U32(6)


def k3_model(tape: np.ndarray, base: np.ndarray) -> np.ndarray:
    """probe_kernel: four warps, warp w rows 8w .. 8w + 7, lane i columns
    4i .. 4i + 3; each lane loads row 0's and base's words of its columns,
    base[0] and its warp's 8 rows (one round trip), then gathers its four
    columns' words (the second; every warp recomputes them), then stores.
    Every output word must be stored exactly once."""
    out = np.zeros((probe.ROWS, probe.C), dtype=U32)
    stores = np.zeros(out.shape, dtype=np.int64)
    warps, warp_rows, lane_cols = 4, 8, 4
    for w in range(warps):
        for lane in range(LANES):
            cols = slice(lane * lane_cols, (lane + 1) * lane_cols)
            n = np.arange(lane * lane_cols, (lane + 1) * lane_cols)
            first, b, b0 = tape[0, cols], base[cols], base[0]
            rows = tape[w * warp_rows:(w + 1) * warp_rows, cols]
            win = b & ~np.int32(127)
            rank = (_accumulated(first) & U32(127)).astype(np.int64)
            f = tape[n, win + rank].astype(U32)
            for r in range(warp_rows):
                o = _accumulated(rows[r]) + f
                if w == 0 and r == 0:
                    o = o * U32(2 if b0 > 0 else 1)
                out[w * warp_rows + r, cols] = o
                stores[w * warp_rows + r, cols] += 1
    assert (stores == 1).all()
    return out.view(np.int32)


def k4_model(tape: np.ndarray, amt: np.ndarray) -> np.ndarray:
    """probe2_kernel: four warps, warp w columns 32w .. 32w + 31; lane c
    loads its column's amt (one round trip) and forms the slab row's first
    word | the lane rotate; the warp shuffles each column's word from its
    lane and every lane loads its 32 columns' stage words (the second);
    then the rank shuffle, the 32 x 33 tile and the row stores."""
    flat = tape.reshape(-1)
    lane = np.arange(LANES)
    out = np.zeros((probe2.ROWS, probe2.C), dtype=U32)
    stores = np.zeros(out.shape, dtype=np.int64)
    for w in range(4):
        a = amt[32 * w:32 * w + 32].astype(np.int64)      # lane c's own amt
        row = (8 - ((a >> 7) & 7)) & 7
        where = (((4 * (32 * w + lane) + (a >> 10)) * 8 + row) * 128) \
            | (a & 127)
        v = np.empty((LANES, 32), dtype=np.int32)          # v[lane][c]
        for c in range(32):
            at = where[c]                                  # __shfl_sync(., c)
            v[:, c] = flat[(at & ~127) + ((lane - at) & 127)]
        u = v.astype(U32)
        rank = (np.where(v < 0, U32(0) - u, u) & U32(7)).astype(np.int64)
        fetched = v[rank, np.arange(32)[None, :]].astype(U32)
        tile = fetched + u                                 # tile[lane][c]
        out[:, 32 * w:32 * w + 32] = tile
        stores[:, 32 * w:32 * w + 32] += 1
    assert (stores == 1).all()
    return out.view(np.int32)


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "edge_base0",
                                  "edge_base511"])
def test_k3_model_matches_plain_and_pallas_interpret(case):
    tape, base = _probe_case(case)
    got = k3_model(tape, base)
    plain = probe.plain(torch.from_numpy(tape), torch.from_numpy(base))
    assert np.array_equal(got, plain.numpy())
    assert np.array_equal(got, _interpret("pallas_probe.py", tape, base))


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "edge"])
def test_k4_model_matches_plain_and_pallas_interpret(case):
    tape, amt = _probe2_case(case)
    got = k4_model(tape, amt)
    plain = probe2.plain(torch.from_numpy(tape), torch.from_numpy(amt))
    assert np.array_equal(got, plain.numpy())
    assert np.array_equal(got, _interpret("pallas_probe2.py", tape, amt))


_I32 = np.iinfo(np.int32)


@pytest.mark.parametrize("v", [_I32.min, _I32.max, -1, 0, 100, 101,
                               "random"])
def test_step_shift_equals_64_wrapping_adds(v):
    """(step << 6) mod 2^32 == 64 wrapping uint32 adds of step, for the
    step of K3 at the int32 edges, at the v > 100 threshold and on random
    int32."""
    vs = (np.random.default_rng(3).integers(_I32.min, _I32.max + 1,
                                            size=4096, dtype=np.int64)
          if v == "random" else np.array([v], dtype=np.int64)).astype(
              np.int32)
    step = (vs >> 1).astype(U32) + (vs > 100).astype(U32)
    acc = np.zeros_like(step)
    for _ in range(64):
        acc = acc + step                                   # wraps mod 2^32
    assert np.array_equal(_accumulated(vs), acc)
    # and as JAX's int32 arithmetic: 64 * step, wrapped
    want = probe.wrap32(64 * ((torch.from_numpy(vs).long() >> 1)
                              + (torch.from_numpy(vs) > 100).long()))
    assert np.array_equal(acc.view(np.int32), want.numpy())


def _off16(t: torch.Tensor, skip: int) -> torch.Tensor:
    """`t`'s values in a view `skip` words past a 16-byte boundary."""
    held = torch.zeros(t.numel() + 8, dtype=t.dtype)
    off = next(k for k in range(4) if held[k:].data_ptr() % 16 == 0) + skip
    view = held[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("skip", [1, 2, 3])
def test_k3_run_takes_misaligned_views(skip):
    """`run`'s domain is the parent's: contiguous views off 16-byte
    alignment are accepted (the kernel then moves words) and give the
    plain version's result."""
    tape, base = (torch.from_numpy(a) for a in probe.inputs(1))
    views = [_off16(t, skip) for t in (tape, base)]
    assert all(v.data_ptr() % 16 == 4 * skip for v in views)
    probe.check_inputs(*views)
    assert torch.equal(probe.run(*views), probe.plain(tape, base))


def test_k3_entry_point_picks_words_for_misaligned_pointers():
    """The C entry point launches the 16-byte variant only when tape, base
    and out are all 16-byte aligned, else the word variant: both are
    instantiated and the choice reads all three pointers."""
    src = open(os.path.join(kernels.CSRC_DIR, "probe.cu")).read()
    entry = src[src.index('extern "C" int picsong_probe('):]
    for ptr in ("tape", "base", "out"):
        assert f"reinterpret_cast<uintptr_t>({ptr})" in entry
    assert "& 15) == 0" in entry
    assert "probe_kernel<true>" in entry and "probe_kernel<false>" in entry


@pytest.mark.parametrize("case", ["seed0", "seed1", "edge_base0"])
def test_k3_bound_counts_the_shift_not_64_adds(case):
    """K3's operations count one shift for the 64 accumulation adds (they
    are equal mod 2^32), so the probe is bound by its bytes."""
    tape, base = (torch.from_numpy(a) for a in _probe_case(case))
    assert probe.OPS_PER_CELL == 5
    ms, by = probe.bound_ms(tape, base)
    assert by == "bytes"
    assert ms == probe.words_moved(tape, base) * 4 / BYTES_PER_S * 1e3


def test_sass_summary_reads_loads_shuffles_and_loops():
    """`kernel_ab.sass_summary` counts a dump's instructions by kind and
    takes a backward branch, not the closing branch to itself, as a
    loop."""
    code = [(0x00, "MOV R1, c[0x0][0x28]"), (0x10, "LDG.E.128 R4, [R2.64]"),
            (0x20, "SHFL.IDX PT, R3, R4, R0, 0x1f"),
            (0x30, "STG.E [R2.64], R3"), (0x40, "EXIT"), (0x50, "BRA 0x50")]
    got = kernel_ab.sass_summary(code)
    assert got == {"instructions": 6, "global_loads": 1, "global_stores": 1,
                   "shuffles": 1, "branches": 1, "loops": False}
    looped = code[:4] + [(0x38, "@!P0 BRA 0x10")] + code[4:]
    assert kernel_ab.sass_summary(looped)["loops"] is True
    assert kernel_ab.sass_summary(looped)["branches"] == 2


@pytest.mark.parametrize("module", [probe, probe2])
def test_probe_cases_are_the_checked_inputs(module):
    """`kernel_ab.probe_cases` hands over the probes' own inputs, seeds 1
    and 2 and the edge inputs, each in the kernel's domain."""
    cases = dict(kernel_ab.probe_cases(module))
    assert list(cases) == ["probe inputs", "seed 1", "seed 2", "edge inputs"]
    for (tape, arg), want in zip(cases.values(), (
            module.inputs(0), module.inputs(1), module.inputs(2),
            module.edge_inputs())):
        assert np.array_equal(tape, want[0]) and np.array_equal(arg, want[1])
        module.check_inputs(torch.from_numpy(tape), torch.from_numpy(arg))


def test_in_turns_times_every_tree_in_every_turn():
    """`kernel_ab.in_turns` runs each timer on each tree's callable in the
    order of the turns and keeps each tree's samples apart."""
    order = []
    fns = {t: (lambda t=t: t) for t in ("this", "other")}
    timers = {"a": lambda fn: (order.append(("a", fn())) or [fn() + "1"]),
              "b": lambda fn: (order.append(("b", fn())) or [1, 2])}
    got = kernel_ab.in_turns(fns, timers, ("other", "this", "this", "other"))
    assert order == [("a", "other"), ("b", "other"), ("a", "this"),
                     ("b", "this"), ("a", "this"), ("b", "this"),
                     ("a", "other"), ("b", "other")]
    assert got == {"a": {"this": ["this1"] * 2, "other": ["other1"] * 2},
                   "b": {"this": [1, 2, 1, 2], "other": [1, 2, 1, 2]}}
    medians = kernel_ab._ab_medians(
        {"device": {"this": [1.0, 2.0, 3.0], "other": [4.0]},
         "call": {"this": [5.0, 7.0], "other": [8.0, 9.0, 10.0]}}, 0.5,
        "bytes")
    assert medians == {"device_ms": 2.0, "other_device_ms": 4.0,
                       "ms": 6.0, "other_ms": 9.0, "ms_min": 5.0,
                       "other_ms_min": 8.0, "bound_ms": 0.5,
                       "bound_by": "bytes", "share_of_bound": 0.25,
                       "other_share_of_bound": 0.125}
