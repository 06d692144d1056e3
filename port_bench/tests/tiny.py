"""Small sizes of each traffic kind, for runs on the CPU."""

# f32 compute, so
# that a sound run reads its gaps at rounding and a planted fault stands
# out against the cell's limits.
TINY = {
    "vit_train": {
        "config": {"hidden_size": 32, "num_hidden_layers": 2,
                   "num_attention_heads": 2, "intermediate_size": 64,
                   "patch_size": 4, "num_labels": 10,
                   "compute_dtype": "float32"},
        "traffic": {"image_size": 16, "batch_per_rank": 4,
                    "reference_chunk": 2}},
    "adag": {
        "config": {"compute_dtype": "float32"},
        "traffic": {"workers": 2, "window": 3, "batch": 8, "rows": 48}},
}

# the kinds' window settings, shortened for runs in the test's process
SHORT = {"vit_train": {"CALIBRATE_STEPS": 2, "TRACE_SECONDS": 0.1},
         "adag": {"CALIBRATE_EPOCHS": 2, "TRACE_EPOCHS": 1}}


def shorten(monkeypatch):
    """Set :data:`SHORT`'s window settings on the kinds' modules."""
    import importlib

    for kind, values in SHORT.items():
        mod = importlib.import_module(f"port_bench.kinds.{kind}")
        for name, value in values.items():
            monkeypatch.setattr(mod, name, value)
