"""The paper's Datalog workloads as program text, and model configurations."""
