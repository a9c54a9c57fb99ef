"""One module per kernel name of a configuration's kernel spec: ``node(arg,
build)`` returns the kernel's parameter names (george's), its starting
parameters and its value as a function of the parameters and the signed
distance ``d`` of 1-D inputs."""
