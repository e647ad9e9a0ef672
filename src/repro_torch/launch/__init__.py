"""Launchers of the port's command-line entry points (`serve`, `train`),
their steps (`steps`) and the assigned input shapes (`shapes`).  The
reference's meshes (`make_host_mesh`, `make_production_mesh`) wait for
ROADMAP Queue 1 item 7."""
from repro_torch.launch.shapes import INPUT_SHAPES, InputShape, shape_applicable

__all__ = ["INPUT_SHAPES", "InputShape", "shape_applicable"]
