from repro_torch.fl.heterogeneity import sample_system_telemetry
from repro_torch.fl.models import (CNN1_SPEC, CNN2_SPEC, MLP_SPEC,
                                   apply_spec, init_cnn_spec, make_eval_fn,
                                   make_local_train_fn, model_bytes)

__all__ = ["sample_system_telemetry", "CNN1_SPEC", "CNN2_SPEC", "MLP_SPEC",
           "apply_spec", "init_cnn_spec", "make_eval_fn",
           "make_local_train_fn", "model_bytes"]
