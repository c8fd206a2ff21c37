'''Training: the first-order parameter gradient of force training
(fastgrad), losses, optimizers, schedulers, the Trainer and its CLI.'''
