"""Host and tensor utilities (counterpart of pbrt_tpu/utils/)."""
from pathlib import Path

# the shared data tables (CIE curves, Sobol' matrices, RGB -> spectrum
# tables), read from the reference package's data directory by path: the
# port imports no module of the JAX package
DATA_DIR = Path(__file__).resolve().parents[2] / "pbrt_tpu" / "data"
