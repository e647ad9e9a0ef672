"""Launchers of the port's command-line entry points (`serve`, `train`,
`dryrun`), their steps and abstract inputs (`steps`), the assigned input
shapes (`shapes`) and the device meshes (`mesh`: the host mesh, and the
production and test meshes, which are abstract).  `dryrun` is imported
on its own, as the reference's is."""
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     make_test_mesh)
from repro_torch.launch.shapes import INPUT_SHAPES, InputShape, shape_applicable

__all__ = ["make_host_mesh", "make_production_mesh", "make_test_mesh",
           "INPUT_SHAPES", "InputShape", "shape_applicable"]
