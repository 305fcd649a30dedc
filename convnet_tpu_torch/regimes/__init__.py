"""Regime engine, schedules and the regime-driven optimizer (counterpart of
convnet_tpu/regimes)."""
