"""Evaluation: EPE/TEPE metrics, the sequence evaluator, visualisations."""
