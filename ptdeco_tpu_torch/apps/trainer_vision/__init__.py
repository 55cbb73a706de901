"""The port's vision trainer CLI (``python -m ptdeco_tpu_torch.apps.trainer_vision.run``):
tasks decompose_dwain, decompose_falor, decompose_lockd and finetune."""
