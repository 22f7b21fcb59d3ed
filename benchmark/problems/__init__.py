"""The program's side of each configuration: the optimization problem that
``tpinn_torch``'s case builders make from the benchmark's inputs."""
