"""The LLM scaffolding's models (port of `repro/models/`): config, layers,
MoE and the unified decoder LM."""
