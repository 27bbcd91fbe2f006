from repro_torch.ckpt.checkpoint import (  # noqa: F401
    save_checkpoint, restore_checkpoint, latest_step, AsyncCheckpointer,
    save_artifact, load_artifact, load_raw, save_bundle, load_bundle,
    bundle_exists,
)
