"""Scene description input (counterpart of pbrt_tpu/scene/): the .pbrt
parser."""
