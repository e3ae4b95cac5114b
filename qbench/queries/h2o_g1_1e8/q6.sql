SELECT id4, id5, median(v3) AS median_v3, stddev(v3) AS sd FROM source GROUP BY id4, id5;
