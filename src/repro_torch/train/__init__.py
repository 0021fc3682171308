"""Step factories (port of `repro/train/`): so far the serve steps."""
