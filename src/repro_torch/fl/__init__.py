from repro_torch.fl.heterogeneity import (ShapeGroup, group_by_shape,
                                          sample_system_telemetry,
                                          shape_signature)
from repro_torch.fl.models import (CNN1_SPEC, CNN2_SPEC, HETERO_A_SPECS,
                                   HETERO_B_SPECS, MLP_SPEC, apply_spec,
                                   init_cnn, init_cnn_spec, init_mlp,
                                   make_eval_fn, make_local_train_fn,
                                   model_bytes)

__all__ = ["sample_system_telemetry", "ShapeGroup", "group_by_shape",
           "shape_signature", "CNN1_SPEC", "CNN2_SPEC", "HETERO_A_SPECS",
           "HETERO_B_SPECS", "MLP_SPEC", "apply_spec", "init_cnn",
           "init_cnn_spec", "init_mlp", "make_eval_fn",
           "make_local_train_fn", "model_bytes"]
