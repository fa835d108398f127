"""The VFL core of the port: exchange, estimator, models, wire, executor."""
