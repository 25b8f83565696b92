from evam_tpu_torch.modelproc.proc import (
    ModelProc,
    OutputPostproc,
    dump_model_proc,
    load_model_proc,
)

__all__ = ["ModelProc", "OutputPostproc", "dump_model_proc", "load_model_proc"]
