"""The harness: traffic, spans, trace reduction, yardstick, checks."""
