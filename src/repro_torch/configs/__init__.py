"""The paper's Datalog workloads as program text."""
