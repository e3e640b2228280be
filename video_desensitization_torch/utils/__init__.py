"""Logging, stage timing, profiling, and native builds."""
