"""Host and tensor utilities (counterpart of pbrt_tpu/utils/)."""
from pathlib import Path

# the shared data tables (CIE curves, Sobol' matrices, RGB -> spectrum
# tables), read by path from the data directory that the program under
# test reads too; no module of either package is imported
DATA_DIR = Path(__file__).resolve().parents[3] / "pbrt_tpu" / "data"
