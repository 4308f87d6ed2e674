"""Run-directory format, device choice and latency gauges."""
