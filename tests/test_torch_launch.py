"""The main-path kernel wrappers' launch path (``kernels/launch.py``) on
the CPU: ``ell_matvec``, ``ell_scatter_add``, ``ell_rmatvec`` /
``ell_colsum``, the three fused passes and ``column_reduce`` keep one plan
per key of dtypes, shapes, devices and widths, check a key in full once
(its cost recorded once), refuse what they refused before also after a
good call of another key, keep no plan for a refused call, and build or
load nothing for CPU tensors. The refusals that only CUDA keys reach are
the plan's checks (``ell.check_plan``), held here directly; the card
tests (``tests/test_torch_cuda.py``) hold the plans on the card."""

import os
import subprocess
import sys

import pytest
import torch

from photon_ml_tpu_torch.kernels import colsort, dispatch, ell, fused, launch
from photon_ml_tpu_torch.ops.losses import LOGISTIC_LOSS, SQUARED_LOSS

D = 50


def _design(n=12, k=4, d=D, dtype=torch.float64):
    g = torch.Generator().manual_seed(5)
    idx = torch.randint(0, d, (n, k), generator=g, dtype=torch.int32)
    idx[::3, -1] = d
    return idx, torch.randn((n, k), generator=g, dtype=torch.float64).to(dtype)


def _rows(n=12, dtype=torch.float64):
    g = torch.Generator().manual_seed(6)
    return [torch.rand(n, generator=g, dtype=torch.float64).to(dtype) for _ in range(3)]


# wrapper -> (module, its dict of plans)
_PLANS = {
    "ell_matvec": (ell, "_matvec_plans"), "ell_scatter_add": (ell, "_scatter_plans"),
    "ell_rmatvec": (ell, "_reduce_plans"), "ell_colsum": (ell, "_reduce_plans"),
    "fused_vgc": (fused, "_vgc_plans"), "fused_hvp": (fused, "_hvp_plans"),
    "fused_hdiag": (fused, "_hdiag_plans"), "colsort_reduce": (colsort, "_reduce_plans"),
}


def _call(name):
    """A call of wrapper ``name`` on CPU tensors."""
    idx, val = _design()
    y, off, ew = _rows()
    w = torch.randn(D, dtype=torch.float64)
    copy = colsort.design_columns(idx, D)
    cvals = colsort.column_values(copy, val)
    return {
        "ell_matvec": lambda: ell.ell_matvec(idx, val, w, D),
        "ell_scatter_add": lambda: ell.ell_scatter_add(idx, val, D),
        "ell_rmatvec": lambda: ell.ell_rmatvec(idx, val, y, D),
        "ell_colsum": lambda: ell.ell_colsum(idx, val, y, D, square=True),
        "fused_vgc": lambda: fused.fused_value_grad_curvature(
            idx, val, y, off, ew, w, D, LOGISTIC_LOSS),
        "fused_hvp": lambda: fused.fused_hessian_vector(idx, val, ew, w, 0.25, D),
        "fused_hdiag": lambda: fused.fused_hessian_diagonal(
            idx, val, y, off, ew, w, D, LOGISTIC_LOSS),
        "colsort_reduce": lambda: colsort.column_reduce(copy, cvals, y, "pair"),
    }[name]


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", list(_PLANS))
def test_a_key_is_checked_once_and_runs_the_plain_version(name, monkeypatch):
    """The full checks and the cost record run once per key: three calls
    keep one plan, the plain version, record one cost, launch nothing and
    give the same outputs."""
    for module, attr in set(_PLANS.values()):
        monkeypatch.setattr(module, attr, {})
    recorded = []
    monkeypatch.setattr(dispatch, "record_kernel_cost",
                        lambda *a, **kw: recorded.append(a[0]))
    call = _call(name)
    before = dispatch.launch_counts()
    outs = [_outputs(call()) for _ in range(3)]
    module, attr = _PLANS[name]
    assert list(getattr(module, attr).values()) == [launch.PLAIN]
    assert recorded.count(name) == 1
    assert dispatch.launch_counts() == before
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], out))


def test_plans_start_anew_past_max_plans(monkeypatch):
    monkeypatch.setattr(launch, "MAX_PLANS", 2)
    monkeypatch.setattr(ell, "_matvec_plans", {})
    for n in (3, 4, 5):
        idx, val = _design(n=n)
        ell.ell_matvec(idx, val, torch.ones(D, dtype=torch.float64), D)
    assert len(ell._matvec_plans) == 1


def test_plans_refuse_what_was_refused_after_a_good_call():
    """A call whose dtype, width or device differs from a good call's is
    checked in full and refused as before, and keeps no plan."""
    idx, val = _design()
    y, off, ew = _rows()
    w = torch.randn(D, dtype=torch.float64)
    ell.ell_matvec(idx, val, w, D)
    count = len(ell._matvec_plans)
    with pytest.raises(TypeError, match="ell_matvec takes"):
        ell.ell_matvec(idx, val, w.float(), D)
    with pytest.raises(ValueError, match="more than one device"):
        ell.ell_matvec(idx, val, w.to("meta"), D)
    with pytest.raises(ValueError, match="no route"):
        ell.ell_matvec(idx.to("meta"), val.to("meta"), w.to("meta"), D)
    assert len(ell._matvec_plans) == count
    ell.ell_scatter_add(idx, val, D)
    with pytest.raises(TypeError, match="float64 or float32 updates"):
        ell.ell_scatter_add(idx, val.to(torch.bfloat16), D)
    with pytest.raises(ValueError, match="more than one device"):
        ell.ell_scatter_add(idx, val.to("meta"), D)
    ell.ell_rmatvec(idx, val, y, D)
    with pytest.raises(ValueError, match="more than one device"):
        ell.ell_rmatvec(idx, val, y.to("meta"), D)
    with pytest.raises(ValueError, match="no route"):
        ell.ell_colsum(idx.to("meta"), val.to("meta"), y.to("meta"), D)
    fused.fused_value_grad_curvature(idx, val, y, off, ew, w, D, LOGISTIC_LOSS)
    with pytest.raises(TypeError, match="fused passes take"):
        fused.fused_value_grad_curvature(idx, val.float(), y, off, ew, w, D, LOGISTIC_LOSS)
    with pytest.raises(ValueError, match="fused passes take the losses"):
        bad = type("Loss", (), {"name": "hinge"})()
        fused.fused_value_grad_curvature(idx, val, y, off, ew, w, D, bad)
    with pytest.raises(ValueError, match="more than one device"):
        fused.fused_value_grad_curvature(idx, val, y, off, ew.to("meta"), w, D, LOGISTIC_LOSS)
    fused.fused_hessian_vector(idx, val, ew, w, 0.5, D)
    with pytest.raises(ValueError, match="more than one device"):
        fused.fused_hessian_vector(idx, val, ew.to("meta"), w, 0.5, D)
    with pytest.raises(TypeError, match="fused passes take"):
        fused.fused_hessian_vector(idx, val.float(), ew, w, 0.5, D)
    fused.fused_hessian_diagonal(idx, val, y, off, ew, w, D, SQUARED_LOSS)
    with pytest.raises(ValueError, match="more than one device"):
        fused.fused_hessian_diagonal(idx, val, y.to("meta"), off, ew, w, D, SQUARED_LOSS)
    copy = colsort.design_columns(idx, D)
    cvals = colsort.column_values(copy, val)
    colsort.column_reduce(copy, cvals, y)
    with pytest.raises(ValueError, match="mode"):
        colsort.column_reduce(copy, cvals, y, "cube")
    with pytest.raises(ValueError, match=r"a must be \(12,\)"):
        colsort.column_reduce(copy, cvals, y[:5])
    with pytest.raises(TypeError, match="column_reduce takes"):
        colsort.column_reduce(copy, cvals.to(torch.bfloat16), y.to(torch.bfloat16))
    with pytest.raises(ValueError, match="more than one device"):
        colsort.column_reduce(copy, cvals, y.to("meta"))


def test_hvp_shift_follows_the_curvature_device():
    """The shift, a host scalar or a 0-dim tensor, is cast to the compute
    type on the curvature's device, as before the plans."""
    idx, val = _design()
    _, _, ew = _rows()
    w = torch.randn(D, dtype=torch.float64)
    a = fused.fused_hessian_vector(idx, val, ew, w, 0.25, D)
    b = fused.fused_hessian_vector(idx, val, ew, w, torch.tensor(0.25, dtype=torch.float32), D)
    ref = fused.fused_hessian_vector_reference(idx, val, ew, w, torch.tensor(0.25,
                                               dtype=torch.float64), D)
    for x, y in zip(a, ref):
        assert torch.equal(x, y)
    for x, y in zip(b, ref):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case,error,match", [
    ("ids", TypeError, "indices must be int32"),
    ("rank", ValueError, r"indices must be \(n, k\)"),
    ("table", ValueError, r"must be the same \(n, k\)"),
    ("rows", ValueError, r"labels must be \(12,\)"),
    ("cols", ValueError, r"w must be \(50,\)"),
    ("width", ValueError, "outside int32"),
])
def test_plan_checks_refuse_what_the_kernels_do_not_take(case, error, match):
    """What a CUDA key is checked for once: int32 (n, k) ids, tables,
    rows and columns of the right shapes, d within int32."""
    idx, val = _design()
    y, _, _ = _rows()
    w = torch.ones(D, dtype=torch.float64)
    kw = dict(tables=[("values", val)], rows=[("labels", y)], cols=[("w", w)])
    d = D
    if case == "ids":
        idx = idx.long()
    elif case == "rank":
        idx = idx.reshape(-1)
    elif case == "table":
        kw["tables"] = [("values", val[:, :2])]
    elif case == "rows":
        kw["rows"] = [("labels", y[:5])]
    elif case == "cols":
        kw["cols"] = [("w", w[:7])]
    elif case == "width":
        d = 2**31
        kw["cols"] = []
    with pytest.raises(error, match=match):
        ell.check_plan("ell_matvec", idx, d, **kw)
    if case != "width":
        ell.check_plan("ell_matvec", *_design()[:1], D, tables=[("values", val)],
                       rows=[("labels", y)], cols=[("w", w)])


def test_pointers_check_contiguity_and_the_alignment_asked_for():
    t = torch.zeros(9, dtype=torch.float32)
    assert launch.pointers("k", ("t",), t) == [t.data_ptr()]
    with pytest.raises(ValueError, match="k: t must start on a 16-byte boundary"):
        launch.pointers("k", ("t",), t[1:])
    assert launch.pointers("k", ("t",), t[1:], align=1) == [t[1:].data_ptr()]
    with pytest.raises(ValueError, match="k: t must be contiguous"):
        launch.pointers("k", ("t",), t.reshape(3, 3).t(), align=1)


def test_cpu_calls_of_the_main_path_wrappers_build_and_load_nothing():
    """No library is built or loaded, and no entry point resolved, by the
    imports or by calls on CPU tensors."""
    code = (
        "import torch\n"
        "from photon_ml_tpu_torch.kernels import build, colsort, ell, fused\n"
        "from photon_ml_tpu_torch.ops.losses import LOGISTIC_LOSS\n"
        "build.build = build.load = None\n"
        "idx = torch.randint(0, 9, (6, 3), dtype=torch.int32)\n"
        "val = torch.rand((6, 3), dtype=torch.float64)\n"
        "r = torch.rand(6, dtype=torch.float64)\n"
        "w = torch.rand(9, dtype=torch.float64)\n"
        "ell.ell_matvec(idx, val, w, 9); ell.ell_scatter_add(idx, val, 9)\n"
        "ell.ell_rmatvec(idx, val, r, 9); ell.ell_colsum(idx, val, r, 9)\n"
        "fused.fused_value_grad_curvature(idx, val, r, r, r, w, 9, LOGISTIC_LOSS)\n"
        "fused.fused_hessian_vector(idx, val, r, w, 0.0, 9)\n"
        "fused.fused_hessian_diagonal(idx, val, r, r, r, w, 9, LOGISTIC_LOSS)\n"
        "c = colsort.design_columns(idx, 9)\n"
        "colsort.column_reduce(c, colsort.column_values(c, val), r)\n"
        "assert not build._loaded and not ell._entries\n"
        "entries = [*ell._MATVEC_ENTRIES.values(), *ell._SCATTER_ENTRIES.values(),\n"
        "           *fused._ENTRIES.values(), *colsort._REDUCE_ENTRIES.values()]\n"
        "assert entries and all(e._fn is None for e in entries)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=300)


def test_every_entry_names_a_source_the_build_knows():
    from photon_ml_tpu_torch.kernels import build

    entries = [*ell._MATVEC_ENTRIES.values(), *ell._SCATTER_ENTRIES.values(),
               *fused._ENTRIES.values(), *colsort._REDUCE_ENTRIES.values()]
    assert {e.library for e in entries} <= set(build.SOURCES)
    assert len({e.name for e in entries}) == len(entries) == 3 + 2 + 9 + 9
    assert all(e.argtypes[-1] is not None for e in entries)
