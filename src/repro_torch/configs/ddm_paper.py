"""The paper's own experimental configuration (§5): DDM workloads.

The port's copy of the JAX package's ``repro/configs/ddm_paper.py``.  N
extents (half subscriptions, half updates) of identical length
l = alpha * L / N placed uniformly on a segment of length L = 1e6;
alpha ∈ {0.01, 1, 100}.  Beyond the paper, the d-dimensional axes:
dims ∈ {1, 2, 3} and the workload shapes of
:data:`repro_torch.data.synthetic.DDM_WORKLOADS` (uniform / clustered /
tall_thin — the latter is the dim-0-non-selective adversary that the
selective-dimension sweep and the bit-matrix AND exist for).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class DDMWorkloadConfig:
    n_extents: int = 1_000_000
    alpha: float = 100.0
    length: float = 1.0e6
    dims: int = 1
    workload: str = "uniform"   # one of repro_torch.data.synthetic.DDM_WORKLOADS
    num_segments: int = 16      # P — sweep segments / devices


ALPHAS = (0.01, 1.0, 100.0)
SIZES = (10_000, 100_000, 1_000_000)
DIMS = (1, 2, 3)
WORKLOADS = ("uniform", "clustered", "tall_thin")
CONFIG = DDMWorkloadConfig()

# the d-dim matrix: tall_thin requires dims >= 2; the 1-d row of the
# matrix is the paper's own configuration above
DDIM_CELLS = tuple(
    (d, w) for d in DIMS for w in WORKLOADS if not (w == "tall_thin" and d < 2)
)
