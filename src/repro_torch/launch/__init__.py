"""The LLM zoo's launch layer: device meshes (``mesh``), logical-axis
sharding rules (``sharding``), input stand-ins and their byte census
(``inputs``), the dry-run over every arch x shape x mesh (``dryrun``, run
as ``python -m repro_torch.launch.dryrun``), step builders (``steps``),
the batched serving driver (``serve``), the hierarchical FL training
driver (``train``), and the encoder run once before a serve run's
prefill (``encode``)."""
from repro_torch.models.transformer import encode

from .inputs import input_specs, serve_input_specs, train_input_specs
from .mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, make_debug_mesh,
                   make_production_mesh, make_sweep_mesh, mesh_axis_size)
from .steps import (init_fl_histories, make_hfl_train_step,
                    make_prefill_step, make_serve_step, make_train_step)

__all__ = [
    "make_production_mesh", "make_debug_mesh", "make_sweep_mesh",
    "mesh_axis_size", "PEAK_FLOPS_BF16", "HBM_BW", "NVLINK_BW",
    "make_hfl_train_step", "make_prefill_step", "make_serve_step",
    "make_train_step", "init_fl_histories",
    "input_specs", "train_input_specs", "serve_input_specs", "encode",
]
