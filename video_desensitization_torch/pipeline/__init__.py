"""The desensitization engine."""
