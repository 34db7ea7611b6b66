"""Rehearse ``chip_smoke.py`` on a CPU-only machine before a chip run.

    python3 scripts/rehearse_chip_smoke.py
    python3 scripts/rehearse_chip_smoke.py --application

The second form runs the application phase (section 7z) alone through
``chip_smoke.application_only`` (``scripts/chip_application.py`` on the
card), on the sizes cut as below: the 32³ stencil and its Jacobi
hierarchy, the 16³ elasticity BDIA matrix (about 70 s). The application
phase's own sizes are cut too: the rule gates' f64
stencil 64³ → 12³, Phalanx 512² → 32², Piro and the trust-region problem
32³ → 12³, L-BFGS's Rosenbrock 2²⁰ → 2¹² (the same counts at every n).

Runs the whole script at small sizes (256³ → 32³, the elasticity, plane,
BDIA, config 2 and config 4 grids cut as below, the uncoupled AMG's 128³ →
16³, config 3's 128² → 32² with the CPU's 29 block steps, maxwell2d 128² →
24², other 128³ cases → 24³, the direct solvers' laplace2d 256² → 32² and
64² → 16², Komplex 128² → 24² with the CPU's count there, the dense solve
4096² → 256², the eigensolvers' 64³ grid → 12³, the FE phase's 80³
hexahedra → 16³, the distributed phases' 256³ and 128³ grids → 32³ and
24³ and their dense LU's 8192² → 512², their one-rank nccl group over
gloo;
the distributed grid held to the JAX package's counts stays 64³; the
distributed s-step run's residual gate is widened to float32's floor at
32³) on the CPU: the rank processes fork from the rehearsal (so they keep its
patches) and run on the CPU over gloo; every kernel wrapper takes its
launch path, and each launch computes the plain version
instead (so the launch counters move and every gate,
count and log line of the script runs); CUDA events time the host, CUDA
graphs become plain calls, the profiler records the CPU only, and
``nvidia-smi`` is not called. It checks control flow, shapes and gates,
not kernels or times. About 330–390 s on a few cores.
"""
import contextlib
import importlib
import pathlib
import sys
import time
import types

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import trilinos_tpu_torch.device as tdev  # noqa: E402


def cpu_device(device=None):
    """Every device request, the card's included, resolves to the CPU."""
    if device is None or str(device).startswith("cuda"):
        return torch.device("cpu")
    return torch.device(device)


# before the package's modules bind resolve_device by name
tdev.resolve_device = cpu_device
from trilinos_tpu_torch.ops import _build  # noqa: E402
stencil_op = importlib.import_module("trilinos_tpu_torch.ops.stencil_op")
dia_mod = importlib.import_module("trilinos_tpu_torch.ops.dia_spmv")
bdia_mod = importlib.import_module("trilinos_tpu_torch.ops.bdia_spmv")
smalldense = importlib.import_module("trilinos_tpu_torch.ops.smalldense")
stencil_poly = importlib.import_module("trilinos_tpu_torch.ops.stencil_poly")
cg_fused = importlib.import_module("trilinos_tpu_torch.ops.cg_fused")
sstep_mod = importlib.import_module("trilinos_tpu_torch.solvers.sstep_gmres")
pdrv = importlib.import_module("trilinos_tpu_torch.parallel.driver")
for m in (stencil_op, dia_mod, bdia_mod, smalldense, stencil_poly, cg_fused,
          sstep_mod):
    m.use_kernel = lambda *a, **k: True


def fake_stencil_call(fn, op, x, y, *extra, plan):
    """The launcher's plan check (the script's refusal case needs it), then
    the plain apply into y."""
    if "spmv" in fn:
        want = stencil_op.spmv_plan(op, x.element_size(),
                                    stencil_op.pointer_align(x, y))
        if plan != want:
            raise RuntimeError("launcher refused the plan")
    y.copy_(stencil_op.stencil_spmv_plain(op, x))


def fake_cg_call(op, vecs, scal, outs, scal_out, work, plan):
    res = cg_fused.cg_fused_iteration_plain(op, *vecs, scal)
    for o, r in zip(outs, res[:5]):
        o.copy_(r)
    scal_out.copy_(res[5])


def fake_bdia(a, x, x3):
    y = torch.empty_like(x)
    torch.as_strided(y, x3.shape, x3.stride()).copy_(
        bdia_mod._apply_plain(a, x3))
    return y


stencil_op._call = fake_stencil_call
cg_fused._call = fake_cg_call
dia_mod._launch = lambda kind, a, x: dia_mod.dia_spmv_plain(a, x)
smalldense._launch = smalldense.chol_inv_small_plain
smalldense.empty_launch = lambda device: None
stencil_poly._launch = lambda op, stages, x, zb, all_outputs, plan: (
    stencil_poly.stencil_powers_plain if all_outputs
    else stencil_poly.stencil_poly_plain)(op, stages, x, zb)
bdia_mod._launch = fake_bdia
_build.build = lambda: {}
# the rank processes fork from this one, so they inherit every patch here
# (a spawned rank would import the unpatched package)
_launch = pdrv.launch
pdrv.launch = lambda *a, **k: _launch(*a, start_method="fork", **k)


class HostEvent:
    """A CUDA event on the host clock."""

    def __init__(self, **kwargs):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class Stream:
    cuda_stream = 0

    def wait_stream(self, other):
        pass


torch.cuda.is_available = lambda: True
torch.cuda.Event = HostEvent
torch.cuda.synchronize = lambda *a: None
torch.cuda.reset_peak_memory_stats = lambda *a: None
torch.cuda.max_memory_allocated = lambda *a: 0
torch.cuda.memory_allocated = lambda *a: 0
torch.cuda.memory_reserved = lambda *a: 0
torch.cuda.memory_stats = lambda *a: {}
torch.cuda.get_device_properties = lambda *a: types.SimpleNamespace(
    total_memory=0)
torch.cuda.get_device_name = lambda *a: "rehearsal"
torch.cuda.device_count = lambda: 1
torch.cuda.device = lambda d: contextlib.nullcontext()
torch.cuda.current_stream = lambda *a: Stream()

src = (ROOT / "chip_smoke.py").read_text()
reps = [("DIMS = (256, 256, 256)", "DIMS = (32, 32, 32)"),
        ("EL_DIMS = (32, 32, 32)", "EL_DIMS = (16, 16, 16)"),
        ("PLANE_DIMS = (64, 64, 48)", "PLANE_DIMS = (8, 8, 8)"),
        ("PLANE_ITERS = 400", "PLANE_ITERS = 60"),
        ("BDIA2D_DIMS = (1024, 512)", "BDIA2D_DIMS = (64, 32)"),
        ("CONFIG2_DIMS = (64, 64, 64)", "CONFIG2_DIMS = (12, 12, 12)"),
        ("CONFIG4_DIMS = (128, 128, 128)", "CONFIG4_DIMS = (24, 24, 24)"),
        ("UAMG_DIMS = (128, 128, 128)", "UAMG_DIMS = (16, 16, 16)"),
        ("CONFIG3_NX = 128", "CONFIG3_NX = 32"),
        ("CONFIG3_CPU_STEPS = 649", "CONFIG3_CPU_STEPS = 29"),
        ("MAXWELL_DIMS = (128, 128)", "MAXWELL_DIMS = (24, 24)"),
        ("CHOL_NX = 256", "CHOL_NX = 32"),
        ("DIRECT_NX = 64", "DIRECT_NX = 16"),
        ("KOMPLEX_NX = 128", "KOMPLEX_NX = 24"),
        ("KOMPLEX_CPU_ITERS = 15", "KOMPLEX_CPU_ITERS = 14"),
        ("DENSE_N = 4096", "DENSE_N = 256"),
        ("DIST_DENSE_N = 8192", "DIST_DENSE_N = 512"),
        # the FE phase's 80³ hexahedra → 16³, where the manufactured
        # solution's O(h²) error is about 6.5e-3
        ("FEM_GRID = (80, 80, 80)", "FEM_GRID = (16, 16, 16)"),
        ("FEM_NODAL_MAX = 1e-3", "FEM_NODAL_MAX = 1e-2"),
        ("EIG_SMALL_DIMS = (64, 64, 64)", "EIG_SMALL_DIMS = (12, 12, 12)"),
        # at 32³ the s-step runs end at float32's rounding floor, where
        # the distributed and single-card residual norms part by ≈ 1e-2
        ("DIST_SSTEP_RTOL = 1e-4", "DIST_SSTEP_RTOL = 5e-2"),
        ("RULE_F64_DIMS = (64, 64, 64)", "RULE_F64_DIMS = (12, 12, 12)"),
        ("PHALANX_N = 512", "PHALANX_N = 32"),
        ("PIRO_DIMS = (32, 32, 32)", "PIRO_DIMS = (12, 12, 12)"),
        ("OPT_DIMS = (32, 32, 32)", "OPT_DIMS = (12, 12, 12)"),
        ("LBFGS_N = 2 ** 20", "LBFGS_N = 2 ** 12"),
        ("(128, 128, 128)", "(24, 24, 24)"),
        ('"cuda"', '"cpu"'),
        ('"nccl"', '"gloo"'),
        (",\n            torch.profiler.ProfilerActivity.CUDA]", "]")]
for a, b in reps:
    assert a in src, a
    src = src.replace(a, b)
ns = {"__name__": "chip_smoke_rehearsal",
      "__file__": str(ROOT / "chip_smoke.py")}
exec(compile(src, "chip_smoke.py", "exec"), ns)
ns["graph_ms"] = ns["time_ms"]
ns["subprocess"] = types.SimpleNamespace(
    run=lambda *a, **k: types.SimpleNamespace(
        stdout="rehearsal on the CPU, no power limit\n"))
ns["SAMPLES"] = 3


if "--application" in sys.argv:
    ns["application_only"]()
else:
    ns["main"]()
