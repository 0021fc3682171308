"""Optimizers and step factories (port of `repro/train/`): AdamW,
Adafactor, the train step and the serve steps."""
