"""Copies of the framework-free utilities of ``act_tpu.utils``."""
