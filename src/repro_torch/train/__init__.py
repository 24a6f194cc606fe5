"""Training: AdamW, the synthetic vision stream and the train-step factory
(the counterpart of ``repro.train``, vision path). ``python -m
repro_torch.train`` trains a Spikingformer on the synthetic stream."""
