"""Serving engine: the predictor adapter over the port's models."""
